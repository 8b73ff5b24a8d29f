// K1 flash_prefill: a chunk of queries appended at a per-row cache offset
// attends causally over the static KV cache.
//
// Replaces: livecc_tpu/ops/pallas/attention.py:flash_prefill (_prefill_kernel),
// the Pallas TPU kernel of the streaming prefill, for a bf16/fp32 cache (the
// int8 branch is flash_prefill_int8.cu).
//
// Contract: q [B, Hq, Sq, D] (strided view), one layer of the cache
// k/v [B, Hk, Smax, D] (the wrapper passes the layer's base pointer of the
// stacked [L, B, Hk, Smax, D] cache, so nothing is sliced or copied),
// offset and kv_limit int32 [B] on the device, read inside the kernel (no
// host sync). Query i of row b sits at position offset[b] + i and attends
// keys kpos <= offset[b] + i with kpos < kv_limit[b]; head h reads KV head
// h // (Hq / Hk). A row with no valid key outputs 0.
//
// What bounds it on the H100: at the streaming shapes (Sq = 1024 bucket,
// Hq = 28, D = 128, ~700-1750 keys) the work is ~4 x pairs x D x Hq FLOPs per
// layer against a few MB of K/V, so it is compute-bound; a verify window
// (Sq = 9) is bound by how many SMs its few blocks fill. bf16 (the model's
// dtype) runs on Hopper's warpgroup products (wgmma_attention.cuh: the G
// query heads of a KV head packed into a tile's rows, K / V by TMA from a
// producer warp, the keys split across blocks to fill the card and the
// partials merged); fp32 (the tiny test model) on the FMA pipes
// (tile_attention.cuh). The dispatch is by dtype alone.
//
// bf16 takes more than fp32: `kv_maps` holds K's and V's tensor maps over
// the stacked cache (two CUtensorMap, from livecc_prefill_kv_map, encoded
// once per cache by the wrapper), `layer` the layer's index into it, and
// with nsplit > 1 `workspace` the split partials, B x Hk x tiles x nsplit x
// 128 rows of D + 2 fp32 (tiles = ceil(Sq / (128 / G))).

#include <cstring>

#include "tile_attention.cuh"
#include "wgmma_attention.cuh"

// K's or V's tensor map over the stacked cache [layers, batch, hk, smax, d]
// (element strides: layer, batch, head, row), written into out[128 bytes]
extern "C" int livecc_prefill_kv_map(const void* base, int layers, int batch, int hk, int smax,
                                     int d, const long long* strides, void* out) {
  CUtensorMap map;
  if (!livecc::wg_kv_map(&map, nullptr, base, d, smax, hk, batch, layers, strides[3], strides[2],
                         strides[1], strides[0]))
    return (int)cudaErrorInvalidValue;
  std::memcpy(out, &map, sizeof map);
  return 0;
}

extern "C" int livecc_flash_prefill(int dtype, const void* q, const void* k, const void* v,
                                    void* o, const int* offset, const int* kv_limit,
                                    int batch, int hq, int hk, int sq, int skv, int d,
                                    const long long* strides, float scale, const void* kv_maps,
                                    int layer, void* workspace, int nsplit, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == livecc::kBFloat16) {
    if (kv_maps == nullptr || batch <= 0 || sq <= 0 || hk <= 0 || hq % hk ||
        hq / hk > livecc::kWgRows || nsplit < 1 || (nsplit > 1 && workspace == nullptr))
      return (int)cudaErrorInvalidValue;
    livecc::WgAttnParams p;
    p.g = hq / hk;
    p.qt = livecc::kWgRows / p.g;
    p.tiles = (sq + p.qt - 1) / p.qt;
    livecc::WgMaps maps;
    if (!livecc::wg_q_maps(maps, q, d, hq, sq, batch, strides[1], strides[2], strides[0], p.g,
                           p.qt, false))
      return (int)cudaErrorInvalidValue;
    std::memcpy(&maps.k, kv_maps, sizeof(CUtensorMap));
    std::memcpy(&maps.v, static_cast<const char*>(kv_maps) + sizeof(CUtensorMap),
                sizeof(CUtensorMap));
    const long long part_rows = (long long)batch * hk * p.tiles * nsplit * livecc::kWgRows;
    p.o = static_cast<__nv_bfloat16*>(o);
    p.o_sb = strides[9];
    p.o_sh = strides[10];
    p.o_ss = strides[11];
    p.offset = offset;
    p.kv_limit = kv_limit;
    p.cu_seqlens = nullptr;
    p.ws = static_cast<float*>(workspace);
    p.ws_ml = workspace ? p.ws + part_rows * d : nullptr;
    p.hk = hk;
    p.nsplit = nsplit;
    p.sq = sq;
    p.skv = skv;
    p.layer = layer;
    p.scale = scale;
    return livecc::with_head_dim(
        d, [&](auto dim) { return livecc::launch_prefill_wgmma<dim()>(maps, p, batch, s); });
  }
  livecc::TileParams p;
  if (dtype != livecc::kFloat32 ||
      !livecc::prefill_params(p, q, k, v, nullptr, nullptr, o, offset, kv_limit, hq, hk, sq,
                              skv, d, strides, scale, false))
    return (int)cudaErrorInvalidValue;
  return livecc::launch_tile_attention<float, true>(p, batch, s);
}
