from .cli import main

if __name__ == "__main__":
    import sys
    try:
        sys.exit(main())
    except BrokenPipeError:
        # stdout reader (head, less) went away: exit quietly like a
        # SIGPIPE'd unix tool
        try:
            sys.stdout.close()
        except Exception:  # noqa: BLE001
            pass
        sys.exit(0)
