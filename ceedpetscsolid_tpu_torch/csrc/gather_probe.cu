// Row-gather probes for NVIDIA Hopper (sm_90a): out[r, :] = tab[idx[r], :].
//
// Replaces the four Pallas-TPU probe kernels of scripts/try_pallas_gather.py,
// which asked whether a row gather can run from on-chip memory, so that the
// element restriction could be fused into the element kernel:
//   K3 k_take   (:44)  jnp.take(tab, idx, axis=0) on a VMEM-resident table
//                      -> gather_take: table slab in shared memory, row-wise
//                         16-byte copies;
//   K4 k_taa    (:56)  take_along_axis with a broadcast index
//                      -> gather_take_along_axis: table slab in shared
//                         memory, one thread per output element;
//   K5 k_loop   (:70)  scalar loop of dynamic row slices, indices in SMEM
//                      -> gather_loop: the block's indices in shared memory,
//                         rows copied from device memory in a loop;
//   K6 k_onehot (:85)  one-hot (R, W) @ (W, C) on the MXU
//                      -> gather_onehot: one-hot tile built in shared memory,
//                         tiled f32 FMA product.
// Each computes exactly tab[idx] (the one-hot product too: every sum is one
// table value plus exact zeros; f32 FMAs keep it exact where TF32 would
// round the table to a 10-bit mantissa). Indices are int32 and are not
// clamped; the wrapper (ops/gather_probe.py) checks shapes, types and
// contiguity.
//
// What bounds them on this card. A gather moves 4*C bytes per output row
// and does no arithmetic, so it is bound by memory traffic: at the probe's
// shape (512 x 128 table, 256 rows) the whole problem is ~0.4 MB and the
// launch dominates; at the production shape (200,000 x 32 table, 1,168,128
// rows, 150 MB out) the 25.6 MB table sits in the 50 MB L2, so the bound is
// the output write plus the L2 reads of the rows. Design responses:
//   * shared-memory staging (K3, K4) is the Hopper form of "the whole table
//     in VMEM": a block may use 227 KB, less than the probe's 256 KB table,
//     so each block stages a column slab of every row (32 columns = 64 KB,
//     dynamic shared memory above 48 KB after cudaFuncSetAttribute); a
//     table whose narrowest slab does not fit is refused by the wrapper;
//   * K3 and K5 copy 16 bytes a thread, consecutive threads on consecutive
//     pieces of a row, so every row read and every output write is
//     coalesced; K5 reads rows straight from device memory (through L2) and
//     so works at any table size;
//   * K6 pays W/C multiply-adds per output value for the privilege of
//     being a matrix product: it is the probe's yardstick, not a candidate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace gp {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = 256;   // K3-K5: output rows per block
constexpr int TR = 32, TC = 32, TW = 32;   // K6 output tile and depth step

// Stage tab[:, c0:c0+slab] (W x slab) into shared memory, 16 bytes a thread.
__device__ __forceinline__ void stage_slab(const float* __restrict__ tab,
                                           int W, int C, int c0, int slab,
                                           float4* s4) {
  const int n4 = slab / 4, C4 = C / 4;
  const float4* tab4 = reinterpret_cast<const float4*>(tab);
  for (int i = threadIdx.x; i < W * n4; i += blockDim.x)
    s4[i] = tab4[(size_t)(i / n4) * C4 + c0 / 4 + i % n4];
}

// K3: rows of the staged slab, copied 16 bytes a thread.
__global__ void __launch_bounds__(THREADS)
take_rows(const float* __restrict__ tab, int W, int C,
          const int* __restrict__ idx, int R, int slab,
          float* __restrict__ out) {
  extern __shared__ float4 s4[];
  const int c0 = blockIdx.x * slab;
  stage_slab(tab, W, C, c0, slab, s4);
  __syncthreads();
  const int n4 = slab / 4, C4 = C / 4;
  const int r0 = blockIdx.y * ROWS_PER_BLOCK;
  const int nr = min(ROWS_PER_BLOCK, R - r0);
  float4* out4 = reinterpret_cast<float4*>(out);
  for (int i = threadIdx.x; i < nr * n4; i += blockDim.x) {
    const int r = r0 + i / n4;
    out4[(size_t)r * C4 + c0 / 4 + i % n4] = s4[idx[r] * n4 + i % n4];
  }
}

// K4: one thread per output element (r, c) reads idx[r] and the staged value.
__global__ void __launch_bounds__(THREADS)
take_elems(const float* __restrict__ tab, int W, int C,
           const int* __restrict__ idx, int R, int slab,
           float* __restrict__ out) {
  extern __shared__ float4 s4[];
  const int c0 = blockIdx.x * slab;
  stage_slab(tab, W, C, c0, slab, s4);
  __syncthreads();
  const float* s = reinterpret_cast<const float*>(s4);
  const int r0 = blockIdx.y * ROWS_PER_BLOCK;
  const int nr = min(ROWS_PER_BLOCK, R - r0);
  for (int i = threadIdx.x; i < nr * slab; i += blockDim.x) {
    const int r = r0 + i / slab, c = i % slab;
    out[(size_t)r * C + c0 + c] = s[idx[r] * slab + c];
  }
}

// K5: the block's indices in shared memory, then a loop over its rows, each
// row copied from device memory; 16 bytes a thread when vec4.
__global__ void __launch_bounds__(THREADS)
loop_rows(const float* __restrict__ tab, int C, const int* __restrict__ idx,
          int R, int vec4, float* __restrict__ out) {
  __shared__ int sidx[ROWS_PER_BLOCK];
  const int r0 = blockIdx.x * ROWS_PER_BLOCK;
  const int nr = min(ROWS_PER_BLOCK, R - r0);
  for (int i = threadIdx.x; i < nr; i += blockDim.x) sidx[i] = idx[r0 + i];
  __syncthreads();
  if (vec4) {
    const int C4 = C / 4;
    const float4* tab4 = reinterpret_cast<const float4*>(tab);
    float4* out4 = reinterpret_cast<float4*>(out);
    for (int i = threadIdx.x; i < nr * C4; i += blockDim.x)
      out4[(size_t)(r0 + i / C4) * C4 + i % C4] =
          tab4[(size_t)sidx[i / C4] * C4 + i % C4];
  } else {
    for (int i = threadIdx.x; i < nr * C; i += blockDim.x)
      out[(size_t)(r0 + i / C) * C + i % C] =
          tab[(size_t)sidx[i / C] * C + i % C];
  }
}

// K6: out tile (TR x TC) = onehot(idx tile) (TR x W) @ tab (W x TC), the
// one-hot and table tiles in shared memory, f32 FMAs in registers.
__global__ void __launch_bounds__(THREADS)
onehot_matmul(const float* __restrict__ tab, int W, int C,
              const int* __restrict__ idx, int R, float* __restrict__ out) {
  __shared__ float oh[TR][TW + 1];
  __shared__ float tb[TW][TC];
  __shared__ int sidx[TR];
  const int r0 = blockIdx.y * TR, c0 = blockIdx.x * TC;
  const int tx = threadIdx.x % TC, ty = threadIdx.x / TC;   // ty < 8
  constexpr int PER = TR / (THREADS / TC);                  // rows a thread
  if (threadIdx.x < TR)
    sidx[threadIdx.x] = r0 + threadIdx.x < R ? idx[r0 + threadIdx.x] : -1;
  float acc[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) acc[k] = 0.0f;
  __syncthreads();
  for (int w0 = 0; w0 < W; w0 += TW) {
    for (int i = threadIdx.x; i < TR * TW; i += blockDim.x)
      oh[i / TW][i % TW] = sidx[i / TW] == w0 + i % TW ? 1.0f : 0.0f;
    for (int i = threadIdx.x; i < TW * TC; i += blockDim.x) {
      const int w = w0 + i / TC, c = c0 + i % TC;
      tb[i / TC][i % TC] = w < W && c < C ? tab[(size_t)w * C + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int w = 0; w < TW; ++w) {
      const float b = tb[w][tx];
#pragma unroll
      for (int k = 0; k < PER; ++k)
        acc[k] = fmaf(oh[ty + k * (THREADS / TC)][w], b, acc[k]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int r = r0 + ty + k * (THREADS / TC), c = c0 + tx;
    if (r < R && c < C) out[(size_t)r * C + c] = acc[k];
  }
}

}  // namespace gp

extern "C" {

// kind: 0 take, 1 take_along_axis, 2 loop, 3 onehot. slab: staged columns
// (kinds 0-1; a multiple of 4 dividing C). vec4 (kind 2): C % 4 == 0 and
// tab, out 16-byte aligned.
// Returns cudaGetLastError() after the launch (0 on success), the error of
// cudaFuncSetAttribute, or -1 for an unknown kind.
int cps_gather_probe(int kind, const void* tab, int W, int C, const void* idx,
                     int R, void* out, int slab, int vec4, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(tab);
  const int* ix = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  const int row_blocks = (R + gp::ROWS_PER_BLOCK - 1) / gp::ROWS_PER_BLOCK;
  if (kind == 0 || kind == 1) {
    const size_t smem = sizeof(float) * (size_t)W * slab;
    const void* fn = kind == 0 ? (const void*)gp::take_rows
                               : (const void*)gp::take_elems;
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid(C / slab, row_blocks);
    if (kind == 0)
      gp::take_rows<<<grid, gp::THREADS, smem, s>>>(t, W, C, ix, R, slab, o);
    else
      gp::take_elems<<<grid, gp::THREADS, smem, s>>>(t, W, C, ix, R, slab, o);
  } else if (kind == 2) {
    gp::loop_rows<<<row_blocks, gp::THREADS, 0, s>>>(t, C, ix, R, vec4, o);
  } else if (kind == 3) {
    dim3 grid((C + gp::TC - 1) / gp::TC, (R + gp::TR - 1) / gp::TR);
    gp::onehot_matmul<<<grid, gp::THREADS, 0, s>>>(t, W, C, ix, R, o);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
