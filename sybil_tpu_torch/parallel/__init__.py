"""The node protocol: the wire format of partial results and the
`aggregate` merge (parallel/mesh.py and multihost.py are not ported yet,
ROADMAP A14, A15)."""
