// Wire format: compact binary encoding of a collective submission's
// metadata (the port's copy of the JAX package's _native/csrc/wire.cc).
//
// Role of the reference's FlatBuffers Request/Response wire format
// (horovod/common/wire/message.fbs, common/message.{h,cc}): the bytes whose
// CRC is the cross-process consistency fingerprint (the reference's
// controller.cc validation is replaced by comparing fingerprints of these
// messages). Layout is fixed little-endian so the pure-Python packer
// (tensor_table.py) produces byte-identical output, and the same bytes as
// the JAX package's for the same metadata:
//
//   u8  version (=1)
//   i32 rank
//   u8  kind_len,  kind bytes
//   u16 name_len,  name bytes
//   u8  dtype_len, dtype bytes
//   u8  ndim,      i64 dims[ndim]
//   u16 extra_len, extra bytes
#include "common.hpp"

namespace hvdtpu {

namespace {

struct CrcTable {
  uint32_t v[256];
  CrcTable() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      v[i] = c;
    }
  }
};

// Built once, on first use; a function-local static is initialized
// thread-safely, so concurrent first calls cannot race on the table.
const uint32_t* crc_table() {
  static const CrcTable table;
  return table.v;
}

struct Writer {
  uint8_t* out;
  int64_t cap;
  int64_t pos = 0;
  bool ok = true;

  void bytes(const void* p, int64_t n) {
    if (pos + n > cap) { ok = false; return; }
    std::memcpy(out + pos, p, n);
    pos += n;
  }
  void u8(uint8_t v) { bytes(&v, 1); }
  void u16(uint16_t v) { uint8_t b[2] = {(uint8_t)(v & 0xff), (uint8_t)(v >> 8)}; bytes(b, 2); }
  void i32(int32_t v) {
    uint8_t b[4];
    for (int i = 0; i < 4; i++) b[i] = (uint8_t)((uint32_t)v >> (8 * i));
    bytes(b, 4);
  }
  void i64(int64_t v) {
    uint8_t b[8];
    for (int i = 0; i < 8; i++) b[i] = (uint8_t)((uint64_t)v >> (8 * i));
    bytes(b, 8);
  }
};

struct Reader {
  const uint8_t* in;
  int64_t len;
  int64_t pos = 0;
  bool ok = true;

  bool need(int64_t n) {
    if (pos + n > len) { ok = false; return false; }
    return true;
  }
  uint8_t u8() { if (!need(1)) return 0; return in[pos++]; }
  uint16_t u16() {
    if (!need(2)) return 0;
    uint16_t v = (uint16_t)(in[pos] | (in[pos + 1] << 8));
    pos += 2;
    return v;
  }
  int32_t i32() {
    if (!need(4)) return 0;
    uint32_t v = 0;
    for (int i = 0; i < 4; i++) v |= (uint32_t)in[pos + i] << (8 * i);
    pos += 4;
    return (int32_t)v;
  }
  int64_t i64() {
    if (!need(8)) return 0;
    uint64_t v = 0;
    for (int i = 0; i < 8; i++) v |= (uint64_t)in[pos + i] << (8 * i);
    pos += 8;
    return (int64_t)v;
  }
  // copies up to cap-1 bytes + NUL into dst
  bool str(int64_t n, char* dst, int64_t cap) {
    if (!need(n)) return false;
    int64_t c = n < cap - 1 ? n : cap - 1;
    if (dst && cap > 0) {
      std::memcpy(dst, in + pos, c);
      dst[c] = '\0';
    }
    pos += n;
    return true;
  }
};

}  // namespace

uint32_t crc32_ieee(const uint8_t* data, int64_t len) {
  const uint32_t* t = crc_table();
  uint32_t c = 0xFFFFFFFFu;
  for (int64_t i = 0; i < len; i++) c = t[(c ^ data[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

}  // namespace hvdtpu

HVD_EXPORT uint32_t hvd_crc32(const uint8_t* buf, int64_t len) {
  return hvdtpu::crc32_ieee(buf, len);
}

HVD_EXPORT int64_t hvd_wire_pack_request(
    const char* name, const int64_t* shape, int32_t ndim, const char* dtype,
    const char* kind, const char* extra, int32_t rank, uint8_t* out,
    int64_t cap) {
  using namespace hvdtpu;
  int64_t name_len = (int64_t)std::strlen(name);
  int64_t dtype_len = (int64_t)std::strlen(dtype);
  int64_t kind_len = (int64_t)std::strlen(kind);
  int64_t extra_len = extra ? (int64_t)std::strlen(extra) : 0;
  if (name_len > 0xFFFF || dtype_len > 0xFF || kind_len > 0xFF ||
      extra_len > 0xFFFF || ndim > 0xFF || ndim < 0)
    return -1;
  Writer w{out, cap};
  w.u8(1);
  w.i32(rank);
  w.u8((uint8_t)kind_len);
  w.bytes(kind, kind_len);
  w.u16((uint16_t)name_len);
  w.bytes(name, name_len);
  w.u8((uint8_t)dtype_len);
  w.bytes(dtype, dtype_len);
  w.u8((uint8_t)ndim);
  for (int32_t i = 0; i < ndim; i++) w.i64(shape[i]);
  w.u16((uint16_t)extra_len);
  if (extra_len) w.bytes(extra, extra_len);
  return w.ok ? w.pos : -1;
}

HVD_EXPORT int64_t hvd_wire_unpack_request(
    const uint8_t* buf, int64_t len, char* name_out, int64_t name_cap,
    int64_t* shape_out, int32_t* ndim_io, char* dtype_out, int64_t dtype_cap,
    char* kind_out, int64_t kind_cap, char* extra_out, int64_t extra_cap,
    int32_t* rank_out) {
  using namespace hvdtpu;
  Reader r{buf, len};
  if (r.u8() != 1) return -1;
  int32_t rank = r.i32();
  int64_t kind_len = r.u8();
  if (!r.str(kind_len, kind_out, kind_cap)) return -1;
  int64_t name_len = r.u16();
  if (!r.str(name_len, name_out, name_cap)) return -1;
  int64_t dtype_len = r.u8();
  if (!r.str(dtype_len, dtype_out, dtype_cap)) return -1;
  int32_t ndim = r.u8();
  if (ndim > *ndim_io) return -1;
  for (int32_t i = 0; i < ndim; i++) {
    int64_t d = r.i64();
    if (shape_out) shape_out[i] = d;
  }
  *ndim_io = ndim;
  int64_t extra_len = r.u16();
  if (!r.str(extra_len, extra_out, extra_cap)) return -1;
  if (!r.ok) return -1;
  if (rank_out) *rank_out = rank;
  return r.pos;
}
