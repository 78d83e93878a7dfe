// Native WAL codec: parse the row-store WAL's typed JSON-lines format
// ({"i": {col: int}, "s": {col: str}, "e": {col: [str, ...]}}) straight
// into columnar arrays with per-column interned string dictionaries.
//
// This is the framework's native data-loader: it replaces the per-row
// Python pivot in digestion (digest.rows_to_columns) and the -read-log
// replay, the host-side equivalents of the reference's row-store decode
// hot loop (src/lib/row_store.go:68 toRecord + table_ingest.go:125
// LoadRowStoreRecords).  Strings are interned per column so Python only
// touches the (small) unique-string set when mapping to the table-wide
// global dictionary.
//
// Any input that falls outside the WAL shape (non-int numbers, unknown
// top-level keys, malformed JSON) returns None and the caller falls back
// to the Python decoder — the native path never guesses.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct StrDict {
  std::unordered_map<std::string, int32_t> interned;
  std::string blob;
  std::vector<uint32_t> offsets{0};

  int32_t intern(const std::string &s) {
    auto it = interned.find(s);
    if (it != interned.end()) return it->second;
    int32_t id = static_cast<int32_t>(offsets.size() - 1);
    interned.emplace(s, id);
    blob.append(s);
    offsets.push_back(static_cast<uint32_t>(blob.size()));
    return id;
  }
};

struct IntCol {
  std::vector<int64_t> vals;
  std::vector<uint8_t> valid;
};

struct StrCol {
  std::vector<int32_t> ids;
  std::vector<uint8_t> valid;
  StrDict dict;
};

struct SetCol {
  std::vector<int32_t> items;       // interned ids, row-major
  std::vector<int32_t> row_counts;  // items per row
  StrDict dict;
};

struct Parser {
  const char *p;
  const char *end;
  bool ok = true;

  explicit Parser(const char *b, const char *e) : p(b), end(e) {}

  void fail() { ok = false; }

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  }

  bool expect(char c) {
    skip_ws();
    if (p < end && *p == c) {
      ++p;
      return true;
    }
    fail();
    return false;
  }

  bool peek(char c) {
    skip_ws();
    return p < end && *p == c;
  }

  // JSON string with full escape handling (json.dumps default is
  // ensure_ascii=True so \uXXXX, incl. surrogate pairs, is the norm).
  bool parse_string(std::string &out) {
    out.clear();
    if (!expect('"')) return false;
    while (p < end) {
      unsigned char c = static_cast<unsigned char>(*p);
      if (c == '"') {
        ++p;
        return true;
      }
      if (c != '\\') {
        if (c < 0x20) { fail(); return false; }
        out.push_back(static_cast<char>(c));
        ++p;
        continue;
      }
      ++p;  // consume backslash
      if (p >= end) { fail(); return false; }
      char e = *p++;
      switch (e) {
        case '"': out.push_back('"'); break;
        case '\\': out.push_back('\\'); break;
        case '/': out.push_back('/'); break;
        case 'b': out.push_back('\b'); break;
        case 'f': out.push_back('\f'); break;
        case 'n': out.push_back('\n'); break;
        case 'r': out.push_back('\r'); break;
        case 't': out.push_back('\t'); break;
        case 'u': {
          uint32_t cp;
          if (!parse_hex4(cp)) return false;
          if (cp >= 0xD800 && cp <= 0xDBFF) {  // high surrogate
            if (p + 1 < end && p[0] == '\\' && p[1] == 'u') {
              p += 2;
              uint32_t lo;
              if (!parse_hex4(lo)) return false;
              if (lo >= 0xDC00 && lo <= 0xDFFF) {
                cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
              } else {
                fail();
                return false;
              }
            } else {
              fail();
              return false;
            }
          } else if (cp >= 0xDC00 && cp <= 0xDFFF) {
            // lone low surrogate (json.dumps emits these for strings
            // that came through surrogateescape decoding): encoding it
            // would produce invalid UTF-8 that crashes the consumer —
            // fail so the caller falls back to the Python decoder,
            // whose json.loads handles such strings.
            fail();
            return false;
          }
          append_utf8(out, cp);
          break;
        }
        default: fail(); return false;
      }
    }
    fail();
    return false;
  }

  bool parse_hex4(uint32_t &out) {
    if (end - p < 4) { fail(); return false; }
    out = 0;
    for (int i = 0; i < 4; ++i) {
      char c = *p++;
      out <<= 4;
      if (c >= '0' && c <= '9') out |= static_cast<uint32_t>(c - '0');
      else if (c >= 'a' && c <= 'f') out |= static_cast<uint32_t>(c - 'a' + 10);
      else if (c >= 'A' && c <= 'F') out |= static_cast<uint32_t>(c - 'A' + 10);
      else { fail(); return false; }
    }
    return true;
  }

  static void append_utf8(std::string &out, uint32_t cp) {
    if (cp < 0x80) {
      out.push_back(static_cast<char>(cp));
    } else if (cp < 0x800) {
      out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
      out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
      out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
      out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
      out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else {
      out.push_back(static_cast<char>(0xF0 | (cp >> 18)));
      out.push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
      out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
      out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    }
  }

  // int64 only; a '.' / 'e' / overflow is a shape violation -> fallback.
  bool parse_int(int64_t &out) {
    skip_ws();
    bool neg = false;
    if (p < end && *p == '-') {
      neg = true;
      ++p;
    }
    if (p >= end || *p < '0' || *p > '9') { fail(); return false; }
    uint64_t acc = 0;
    const uint64_t lim = neg ? 0x8000000000000000ULL : 0x7FFFFFFFFFFFFFFFULL;
    while (p < end && *p >= '0' && *p <= '9') {
      uint64_t d = static_cast<uint64_t>(*p - '0');
      if (acc > (lim - d) / 10) { fail(); return false; }
      acc = acc * 10 + d;
      ++p;
    }
    if (p < end && (*p == '.' || *p == 'e' || *p == 'E')) { fail(); return false; }
    if (neg && acc == 0x8000000000000000ULL) out = INT64_MIN;
    else out = neg ? -static_cast<int64_t>(acc) : static_cast<int64_t>(acc);
    return true;
  }
};

struct Batch {
  Py_ssize_t n = 0;
  std::unordered_map<std::string, IntCol> ints;
  std::unordered_map<std::string, StrCol> strs;
  std::unordered_map<std::string, SetCol> sets;

  IntCol &int_col(const std::string &name) {
    auto it = ints.find(name);
    if (it != ints.end()) return it->second;
    IntCol &c = ints[name];
    c.vals.assign(static_cast<size_t>(n), 0);
    c.valid.assign(static_cast<size_t>(n), 0);
    return c;
  }
  StrCol &str_col(const std::string &name) {
    auto it = strs.find(name);
    if (it != strs.end()) return it->second;
    StrCol &c = strs[name];
    c.ids.assign(static_cast<size_t>(n), 0);
    c.valid.assign(static_cast<size_t>(n), 0);
    return c;
  }
  SetCol &set_col(const std::string &name) {
    auto it = sets.find(name);
    if (it != sets.end()) return it->second;
    SetCol &c = sets[name];
    c.row_counts.assign(static_cast<size_t>(n), 0);
    return c;
  }
};

bool parse_record(Parser &ps, Batch &b, Py_ssize_t row) {
  if (!ps.expect('{')) return false;
  if (ps.peek('}')) { ++ps.p; return true; }
  std::string key, name, sval;
  while (true) {
    if (!ps.parse_string(key)) return false;
    if (!ps.expect(':')) return false;
    if (key == "i") {
      if (!ps.expect('{')) return false;
      if (!ps.peek('}')) {
        while (true) {
          int64_t v;
          if (!ps.parse_string(name) || !ps.expect(':') || !ps.parse_int(v))
            return false;
          IntCol &c = b.int_col(name);
          c.vals[static_cast<size_t>(row)] = v;
          c.valid[static_cast<size_t>(row)] = 1;
          if (ps.peek(',')) { ++ps.p; continue; }
          break;
        }
      }
      if (!ps.expect('}')) return false;
    } else if (key == "s") {
      if (!ps.expect('{')) return false;
      if (!ps.peek('}')) {
        while (true) {
          if (!ps.parse_string(name) || !ps.expect(':') ||
              !ps.parse_string(sval))
            return false;
          StrCol &c = b.str_col(name);
          c.ids[static_cast<size_t>(row)] = c.dict.intern(sval);
          c.valid[static_cast<size_t>(row)] = 1;
          if (ps.peek(',')) { ++ps.p; continue; }
          break;
        }
      }
      if (!ps.expect('}')) return false;
    } else if (key == "e") {
      if (!ps.expect('{')) return false;
      if (!ps.peek('}')) {
        while (true) {
          if (!ps.parse_string(name) || !ps.expect(':') || !ps.expect('['))
            return false;
          SetCol &c = b.set_col(name);
          int32_t cnt = 0;
          if (!ps.peek(']')) {
            while (true) {
              if (!ps.parse_string(sval)) return false;
              c.items.push_back(c.dict.intern(sval));
              ++cnt;
              if (ps.peek(',')) { ++ps.p; continue; }
              break;
            }
          }
          if (!ps.expect(']')) return false;
          c.row_counts[static_cast<size_t>(row)] = cnt;
          if (ps.peek(',')) { ++ps.p; continue; }
          break;
        }
      }
      if (!ps.expect('}')) return false;
    } else {
      return false;  // unknown top-level key: not WAL shape
    }
    if (ps.peek(',')) { ++ps.p; continue; }
    break;
  }
  return ps.expect('}');
}

PyObject *bytes_of(const void *data, size_t nbytes) {
  return PyBytes_FromStringAndSize(static_cast<const char *>(data),
                                   static_cast<Py_ssize_t>(nbytes));
}

PyObject *dict_sections(const StrDict &d) {
  // -> (dict_blob, dict_offsets uint32[D+1])
  PyObject *blob = bytes_of(d.blob.data(), d.blob.size());
  PyObject *offs = bytes_of(d.offsets.data(), d.offsets.size() * 4);
  if (!blob || !offs) {
    Py_XDECREF(blob);
    Py_XDECREF(offs);
    return nullptr;
  }
  PyObject *t = PyTuple_Pack(2, blob, offs);
  Py_DECREF(blob);
  Py_DECREF(offs);
  return t;
}

// parse(data: bytes) -> dict | None
//   {"n": int,
//    "ints": {name: (vals_i64, valid_u8)},
//    "strs": {name: (ids_i32, valid_u8, (dict_blob, dict_offs_u32))},
//    "sets": {name: (items_i32, counts_i32, (dict_blob, dict_offs_u32))}}
PyObject *parse(PyObject *, PyObject *arg) {
  char *buf;
  Py_ssize_t len;
  if (PyBytes_AsStringAndSize(arg, &buf, &len) < 0) return nullptr;

  // pass 1: count non-empty lines
  Batch b;
  {
    const char *q = buf;
    const char *e = buf + len;
    while (q < e) {
      const char *nl = static_cast<const char *>(memchr(q, '\n', e - q));
      const char *stop = nl ? nl : e;
      const char *s = q;
      while (s < stop && (*s == ' ' || *s == '\t' || *s == '\r')) ++s;
      if (s < stop) ++b.n;
      q = nl ? nl + 1 : e;
    }
  }

  // pass 2: parse each line, releasing the GIL for the duration
  bool ok = true;
  Py_BEGIN_ALLOW_THREADS
  {
    const char *q = buf;
    const char *e = buf + len;
    Py_ssize_t row = 0;
    while (q < e && ok) {
      const char *nl = static_cast<const char *>(memchr(q, '\n', e - q));
      const char *stop = nl ? nl : e;
      const char *s = q;
      while (s < stop && (*s == ' ' || *s == '\t' || *s == '\r')) ++s;
      if (s < stop) {
        Parser ps(s, stop);
        if (!parse_record(ps, b, row)) ok = false;
        else {
          ps.skip_ws();
          if (ps.p != stop) ok = false;  // trailing garbage
        }
        ++row;
      }
      q = nl ? nl + 1 : e;
    }
  }
  Py_END_ALLOW_THREADS

  if (!ok) Py_RETURN_NONE;

  PyObject *out = PyDict_New();
  PyObject *ints = PyDict_New();
  PyObject *strs = PyDict_New();
  PyObject *sets = PyDict_New();
  PyObject *nobj = PyLong_FromSsize_t(b.n);
  if (!out || !ints || !strs || !sets || !nobj) goto error;
  if (PyDict_SetItemString(out, "n", nobj) < 0 ||
      PyDict_SetItemString(out, "ints", ints) < 0 ||
      PyDict_SetItemString(out, "strs", strs) < 0 ||
      PyDict_SetItemString(out, "sets", sets) < 0)
    goto error;

  for (auto &kv : b.ints) {
    PyObject *vals = bytes_of(kv.second.vals.data(), kv.second.vals.size() * 8);
    PyObject *valid = bytes_of(kv.second.valid.data(), kv.second.valid.size());
    PyObject *t = (vals && valid) ? PyTuple_Pack(2, vals, valid) : nullptr;
    Py_XDECREF(vals);
    Py_XDECREF(valid);
    if (!t || PyDict_SetItemString(ints, kv.first.c_str(), t) < 0) {
      Py_XDECREF(t);
      goto error;
    }
    Py_DECREF(t);
  }
  for (auto &kv : b.strs) {
    PyObject *ids = bytes_of(kv.second.ids.data(), kv.second.ids.size() * 4);
    PyObject *valid = bytes_of(kv.second.valid.data(), kv.second.valid.size());
    PyObject *d = dict_sections(kv.second.dict);
    PyObject *t = (ids && valid && d) ? PyTuple_Pack(3, ids, valid, d) : nullptr;
    Py_XDECREF(ids);
    Py_XDECREF(valid);
    Py_XDECREF(d);
    if (!t || PyDict_SetItemString(strs, kv.first.c_str(), t) < 0) {
      Py_XDECREF(t);
      goto error;
    }
    Py_DECREF(t);
  }
  for (auto &kv : b.sets) {
    PyObject *items =
        bytes_of(kv.second.items.data(), kv.second.items.size() * 4);
    PyObject *counts =
        bytes_of(kv.second.row_counts.data(), kv.second.row_counts.size() * 4);
    PyObject *d = dict_sections(kv.second.dict);
    PyObject *t =
        (items && counts && d) ? PyTuple_Pack(3, items, counts, d) : nullptr;
    Py_XDECREF(items);
    Py_XDECREF(counts);
    Py_XDECREF(d);
    if (!t || PyDict_SetItemString(sets, kv.first.c_str(), t) < 0) {
      Py_XDECREF(t);
      goto error;
    }
    Py_DECREF(t);
  }
  Py_DECREF(ints);
  Py_DECREF(strs);
  Py_DECREF(sets);
  Py_DECREF(nobj);
  return out;

error:
  Py_XDECREF(out);
  Py_XDECREF(ints);
  Py_XDECREF(strs);
  Py_XDECREF(sets);
  Py_XDECREF(nobj);
  return nullptr;
}

PyMethodDef methods[] = {
    {"parse", parse, METH_O,
     "parse(wal_bytes) -> columnar dict, or None if not WAL-shaped"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_walcodec",
    "native WAL JSON-lines -> columnar decoder", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__walcodec(void) { return PyModule_Create(&moduledef); }
