// K3 vit_group_attention: bidirectional ViT attention within segments given
// by their bounds, the uniform temporal groups of one grid or segments of
// mixed sizes alike.
//
// Replaces: livecc_tpu/ops/pallas/vit_attention.py:vit_group_attention
// (_vit_attention_call, _vit_attn_kernel), forward only (the backward is
// the plain version's vjp, ops/vit_attention.py:_K3), and the ViT's
// segment-mask `mha` path for mixed grids
// (livecc_tpu/models/qwen2_vl/vision.py:121), whose equality mask over runs
// of equal ids is attention within each run.
//
// Contract: q, k, v, o [N, H, D] token-major as the ViT holds them, read
// through their (row, head) strides; cu_seqlens int32 [nseg + 1] on the
// device: segment z holds the rows [cu[z], cu[z + 1]); nseg, the longest
// segment (max_len) and N (`rows`) are host ints, so the grid is
// (ceil(max_len / 128), H, nseg) and a block whose query tile starts past
// its segment's end exits. D = 80 for the 7B ViT. fp32 scores and softmax,
// unnormalised probabilities rounded to v's dtype for the p.v product,
// normalisation after p.v, as the TPU kernel does.
//
// What bounds it on the H100: at the 720p serving budget g = 880, H = 16,
// D = 80 the work is 4 x g^2 x D x H FLOPs per group and layer against
// ~4 x g x H x D x 2 bytes of traffic, so it is compute-bound (plus g^2 x H
// exps). The TPU kernel held a whole [g, g] score block in VMEM; a Hopper SM
// has at most 227 KB of shared memory, so the kernel streams key tiles with
// an online softmax instead, which also removes the TPU's MAX_GROUP limit.
// bf16 (the model's dtype) runs on Hopper's warpgroup products
// (wgmma_attention.cuh; D = 80 as a 64-column and a 16-column tail chunk);
// fp32 (the tiny test model) on the FMA pipes (tile_attention.cuh). The
// dispatch is by dtype alone. D = 80 with its tail ran 1.12x / 1.16x faster
// than D rounded up to 128 by TMA's zero fill at NG = 8 / 32 (PERF.md).

#include "tile_attention.cuh"
#include "wgmma_attention.cuh"

namespace {

template <int D, bool kTail>
int launch_vit_wgmma(const void* q, const void* k, const void* v, void* o, const int* cu_seqlens,
                     int nseg, int max_len, int rows, int heads, const long long* strides,
                     float scale, cudaStream_t stream) {
  livecc::WgMaps maps;
  // row, head strides of q, k, v, o; the batch and layer dims hold one entry
  const long long* s = strides;
  if (!livecc::wg_q_maps(maps, q, D, heads, rows, 1, s[1], s[0], 0, 1, livecc::kWgRows, kTail) ||
      !livecc::wg_kv_map(&maps.k, kTail ? &maps.k_tail : nullptr, k, D, rows, heads, 1, 1, s[2],
                         s[3], 0, 0) ||
      !livecc::wg_kv_map(&maps.v, kTail ? &maps.v_tail : nullptr, v, D, rows, heads, 1, 1, s[4],
                         s[5], 0, 0))
    return (int)cudaErrorInvalidValue;
  livecc::WgAttnParams p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_sb = 0;
  p.o_ss = s[6];
  p.o_sh = s[7];
  p.offset = p.kv_limit = nullptr;
  p.cu_seqlens = cu_seqlens;
  p.ws = p.ws_ml = nullptr;
  p.hk = heads;
  p.g = 1;
  p.qt = livecc::kWgRows;
  p.tiles = (max_len + livecc::kWgRows - 1) / livecc::kWgRows;
  p.nsplit = 1;
  p.sq = p.skv = max_len;
  p.layer = 0;
  p.scale = scale;
  return livecc::launch_wgmma_attention<D, kTail, false>(maps, p, dim3(p.tiles, heads, nseg),
                                                         stream);
}

}  // namespace

// strides: (row, head) of q, k, v, o in elements
extern "C" int livecc_vit_attention(int dtype, const void* q, const void* k, const void* v,
                                    void* o, const int* cu_seqlens, int nseg, int max_len,
                                    int rows, int heads, int d, const long long* strides,
                                    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nseg <= 0 || max_len <= 0 || rows <= 0 || heads <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == livecc::kBFloat16 && d == 80)   // the 7B ViT's: 64 columns and a 16-column tail
    return launch_vit_wgmma<80, true>(q, k, v, o, cu_seqlens, nseg, max_len, rows, heads, strides,
                                      scale, s);
  if (dtype == livecc::kBFloat16)              // rounded up to 64 or 128
    return livecc::with_head_dim(d, [&](auto dim) {
      return launch_vit_wgmma<dim(), false>(q, k, v, o, cu_seqlens, nseg, max_len, rows, heads,
                                            strides, scale, s);
    });
  if (dtype != livecc::kFloat32 || d <= 0 || d > livecc::kMaxHeadDim || d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  livecc::TileParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.offset = nullptr;
  p.kv_limit = nullptr;
  p.k_scale = nullptr;
  p.v_scale = nullptr;
  p.cu_seqlens = cu_seqlens;
  p.hq = heads;
  p.hk = heads;
  p.sq = max_len;
  p.skv = max_len;
  p.d = d;
  p.q_sb = 0;  p.q_ss = strides[0];  p.q_sh = strides[1];
  p.k_sb = 0;  p.k_ss = strides[2];  p.k_sh = strides[3];
  p.v_sb = 0;  p.v_ss = strides[4];  p.v_sh = strides[5];
  p.o_sb = 0;  p.o_ss = strides[6];  p.o_sh = strides[7];
  p.ks_sb = p.ks_sh = p.vs_sb = p.vs_sh = 0;
  p.scale = scale;
  return livecc::launch_tile_attention<float, false>(p, nseg, s);
}
