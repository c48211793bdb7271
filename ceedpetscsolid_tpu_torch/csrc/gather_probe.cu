// Row-gather probes for NVIDIA Hopper (sm_90a): out[r, :] = tab[idx[r], :].
//
// Replaces the four Pallas-TPU probe kernels of scripts/try_pallas_gather.py,
// which asked whether a row gather can run from on-chip memory, so that the
// element restriction could be fused into the element kernel:
//   K3 k_take   (:44)  jnp.take(tab, idx, axis=0) on a VMEM-resident table
//                      -> gather_take: the table resident in the distributed
//                         shared memory of a thread-block cluster, filled by
//                         TMA bulk copies; whole rows, 16 bytes a thread;
//   K4 k_taa    (:56)  take_along_axis with a broadcast index
//                      -> gather_take_along_axis: the same cluster-resident
//                         table, one thread per output element;
//   K5 k_loop   (:70)  scalar loop of dynamic row slices, indices in SMEM
//                      -> gather_loop: the block's indices in shared memory,
//                         rows copied from device memory in a loop;
//   K6 k_onehot (:85)  one-hot (R, W) @ (W, C) on the MXU
//                      -> gather_onehot: one-hot tile built in shared memory,
//                         tiled f32 FMA product.
// The wrapper (ops/gather_probe.py) checks shapes, types and contiguity and
// makes K3/K4's launch plan.
//
// Index contract. For any int32 index each kernel gives what the JAX op of
// its TPU body gives, W being the table's rows:
//   K3, K4 (jnp.take / take_along_axis, default "fill" mode): a negative
//     index wraps once (i + W); an index still outside [0, W) gives a row of
//     the canonical quiet NaN, 0x7fc00000;
//   K5 (pl.ds, a lax.dynamic_slice): wrap once, then clamp into [0, W - 1];
//   K6 (iota == idx): a row of zeros for any index outside [0, W).
// Each is one compare-and-select where the kernel reads the row index. Rows
// in range are bitwise tab[idx] (the one-hot product too: every sum is one
// table value plus exact zeros; f32 FMAs keep it exact where TF32 would
// round the table to a 10-bit mantissa).
//
// What bounds them on this card. A gather moves 4*C bytes per output row and
// does no arithmetic. At the probe's shape (512 x 128 table, 256 rows: a 256
// KB table, 128 KB out) the bound is latency: the time until a block's table
// rows are on chip, then one pass of writes. At the production shape
// (200,000 x 32 table, 1,168,128 rows, 150 MB out) the 25.6 MB table sits in
// the 50 MB L2, so the bound is the output write plus the L2 reads.
// Design responses:
//   * K3/K4 keep the table in a cluster of cs = min(8, W) blocks (8 is the
//     portable cluster size): block k of the cluster owns table rows
//     [k rows, (k + 1) rows), rows = ceil(W / cs), and fills them with one
//     cp.async.bulk global->shared copy that completes on an mbarrier
//     (complete_tx bytes); then cluster.sync(). That is the Hopper form of
//     "the whole table in VMEM": the probe's 256 KB table is more than the
//     227 KB one block may use, but 64 rows x 512 B = 32 KB a block in a
//     cluster of 8, one copy each, 8 fills in flight at once.
//   * Each block then writes its share of the cluster's output rows and reads
//     row idx[r] from the owning block's shared memory through
//     cooperative_groups' map_shared_rank (distributed shared memory). The
//     block stages each row's resolved (owner, local row), 256 rows at a time
//     (the first 256 while its fill is in flight), so K4's threads read one
//     shared word per element, not idx from device memory. A last
//     cluster.sync() keeps every block's shared memory alive until its
//     readers are done.
//   * Grid (cs, C / slab, groups), cluster (cs, 1, 1): clusters tile the
//     output rows, groups = clamp(ceil(R / (32 cs)), 1, 16 / (C / slab)), so
//     a block gets at least 32 output rows and at most 16 clusters of 8 run
//     (132 SMs, one block each at full shared memory). Every cluster reads
//     the table again, from L2.
//   * A table larger than a cluster's shared memory is cut into column slabs:
//     the widest multiple of 4 dividing C whose `rows` rows fit. A slab's rows
//     are not contiguous, so each row is a bulk copy of its own, issued by
//     the 32 lanes of warp 0 on the one mbarrier: that needs no tensor map
//     (cuTensorMapEncodeTiled), and at 16 bytes or more a row each copy is
//     a legal bulk copy. Refused by the wrapper, which names gather_loop:
//     C % 4 != 0 (bulk copies move multiples of 16 bytes from 16-byte
//     aligned addresses) and tables of more than 8 x 14,463 rows.
//   * Host path: the shared-memory limit is set once per device
//     (cps_gather_probe_init), the launch is cudaLaunchKernelEx with a
//     cluster-dimension attribute, and the plan is cached by the wrapper.
//   * K3 and K5 copy 16 bytes a thread, consecutive threads on consecutive
//     pieces of a row, so every row read and every output write is coalesced;
//     K5 reads rows straight from device memory (through L2) and so works at
//     any table size;
//   * K6 pays W/C multiply-adds per output value for the privilege of being a
//     matrix product: it is the probe's yardstick, not a candidate.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace gp {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = 256;   // K5: output rows per block
constexpr int CHUNK = 256;            // K3/K4: output rows staged at a time
constexpr int TR = 32, TC = 32, TW = 32;   // K6 output tile and depth step
constexpr unsigned QNAN = 0x7fc00000u;     // jnp.take's fill value

// K3/K4 dynamic shared memory: the table part (rows x slab floats), the
// staged row indices (CHUNK ints), the mbarrier. ops/gather_probe.Plan.smem
// is the same sum.
__host__ __device__ constexpr size_t staged_smem(int rows, int slab) {
  return sizeof(float) * (size_t)rows * slab + sizeof(int) * CHUNK +
         sizeof(uint64_t);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into this block's shared memory; completes
// `bytes` of the transaction count of `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <typename V>
__device__ __forceinline__ V qnan();
template <>
__device__ __forceinline__ float qnan<float>() {
  return __uint_as_float(QNAN);
}
template <>
__device__ __forceinline__ float4 qnan<float4>() {
  const float q = __uint_as_float(QNAN);
  return make_float4(q, q, q, q);
}

// K3 (V = float4, 16 bytes a thread) and K4 (V = float, one thread per
// output element) from a cluster-resident table: see the header.
template <typename V>
__global__ void __launch_bounds__(THREADS)
cluster_take(const float* __restrict__ tab, int W, int C,
             const int* __restrict__ idx, int R, int rows, int slab,
             int rows_per_cluster, float* __restrict__ out) {
  constexpr int VW = sizeof(V) / sizeof(float);
  extern __shared__ __align__(128) unsigned char smem[];
  float* stab = reinterpret_cast<float*>(smem);
  int* sidx =
      reinterpret_cast<int*>(smem + sizeof(float) * (size_t)rows * slab);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sidx + CHUNK);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int c0 = blockIdx.y * slab;

  // fill: table rows [w0, w0 + nw) x columns [c0, c0 + slab)
  const int w0 = rank * rows;
  const int nw = max(0, min(rows, W - w0));
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0)
      mbar_arrive_expect_tx(bar, sizeof(float) * (uint32_t)nw * slab);
    __syncwarp();
    if (slab == C) {            // contiguous rows: one copy
      if (threadIdx.x == 0 && nw > 0)
        bulk_load(stab, tab + (size_t)w0 * C, sizeof(float) * nw * C, bar);
    } else {                    // a column slab: one copy per row
      for (int w = threadIdx.x; w < nw; w += 32)
        bulk_load(stab + (size_t)w * slab, tab + (size_t)(w0 + w) * C + c0,
                  sizeof(float) * slab, bar);
    }
  }
  // this block's share of the cluster's output rows
  const int g0 = blockIdx.z * rows_per_cluster;
  const int gn = min(rows_per_cluster, R - g0);
  const int per = (gn + cs - 1) / cs;
  const int r0 = g0 + rank * per;
  const int nr = max(0, min(per, g0 + gn - r0));
  // stage rows [r0 + k, r0 + k + CHUNK) as (owner block << 16 | local row),
  // or -1 for an index outside [0, W) after the wrap (a NaN row)
  auto stage = [&](int k) {
    for (int i = threadIdx.x; i < min(CHUNK, nr - k); i += blockDim.x) {
      int j = idx[r0 + k + i];
      if (j < 0) j += W;        // wrap once
      sidx[i] = (unsigned)j < (unsigned)W ? ((j / rows) << 16) | (j % rows)
                                            : -1;
    }
  };
  stage(0);                     // the first chunk's loads overlap the fill
  mbar_wait(bar, 0);
  cluster.sync();               // every block's rows are in, cluster-wide

  const int nv = slab / VW, CV = C / VW;
  V* outv = reinterpret_cast<V*>(out) + c0 / VW;
  for (int k = 0; k < nr; k += CHUNK) {
    if (k > 0) {
      __syncthreads();          // the last chunk's readers of sidx are done
      stage(k);
      __syncthreads();
    }
    const int n = min(CHUNK, nr - k);
    for (int i = threadIdx.x; i < n * nv; i += blockDim.x) {
      const int row = i / nv, v = i - row * nv;
      const int s = sidx[row];
      V val = qnan<V>();
      if (s >= 0) {
        const V* src = cluster.map_shared_rank(
            reinterpret_cast<const V*>(stab), s >> 16);
        val = src[(size_t)(s & 0xffff) * nv + v];
      }
      outv[(size_t)(r0 + k + row) * CV + v] = val;
    }
  }
  cluster.sync();               // readers of this block's rows are done
}

// K5: the block's indices in shared memory, then a loop over its rows, each
// row copied from device memory; 16 bytes a thread when vec4.
__global__ void __launch_bounds__(THREADS)
loop_rows(const float* __restrict__ tab, int W, int C,
          const int* __restrict__ idx, int R, int vec4,
          float* __restrict__ out) {
  __shared__ int sidx[ROWS_PER_BLOCK];
  const int r0 = blockIdx.x * ROWS_PER_BLOCK;
  const int nr = min(ROWS_PER_BLOCK, R - r0);
  for (int i = threadIdx.x; i < nr; i += blockDim.x) {
    int j = idx[r0 + i];
    if (j < 0) j += W;          // wrap once, then clamp into [0, W - 1]
    sidx[i] = min(max(j, 0), W - 1);
  }
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
// one-hot and table tiles in shared memory, f32 FMAs in registers. An index
// outside [0, W) matches no table row (a padded row past W holds zeros), so
// its output row is zeros.
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

template <typename V>
cudaError_t launch_take(const float* t, int W, int C, const int* ix, int R,
                        float* o, int cs, int rows, int slab, int groups,
                        int rows_per_cluster, cudaStream_t s) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, C / slab, groups);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = staged_smem(rows, slab);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, cluster_take<V>, t, W, C, ix, R, rows, slab,
                            rows_per_cluster, o);
}

}  // namespace gp

extern "C" {

// Once per device, before the first K3/K4 launch on it: let both cluster
// kernels use up to smem_limit bytes of dynamic shared memory. Returns the
// cudaError_t (0 on success).
int cps_gather_probe_init(int smem_limit) {
  cudaError_t e = cudaFuncSetAttribute(
      gp::cluster_take<float4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_limit);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gp::cluster_take<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_limit);
  return static_cast<int>(e);
}

// kind: 0 take, 1 take_along_axis, 2 loop, 3 onehot. Kinds 0-1 take the
// launch plan of ops/gather_probe.plan: cluster size cs, table rows a block
// holds, slab columns (a multiple of 4 dividing C), groups of clusters along
// the output rows and rows per cluster; tab 16-byte aligned. vec4 (kind 2):
// C % 4 == 0 and tab 16-byte aligned. Returns the launch's cudaError_t, then
// cudaGetLastError() (0 on success), or -1 for an unknown kind.
int cps_gather_probe(int kind, const void* tab, int W, int C, const void* idx,
                     int R, void* out, int cs, int rows, int slab, int groups,
                     int rows_per_cluster, int vec4, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(tab);
  const int* ix = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  cudaError_t e = cudaSuccess;
  if (kind == 0) {
    e = gp::launch_take<float4>(t, W, C, ix, R, o, cs, rows, slab, groups,
                                rows_per_cluster, s);
  } else if (kind == 1) {
    e = gp::launch_take<float>(t, W, C, ix, R, o, cs, rows, slab, groups,
                               rows_per_cluster, s);
  } else if (kind == 2) {
    const int blocks = (R + gp::ROWS_PER_BLOCK - 1) / gp::ROWS_PER_BLOCK;
    gp::loop_rows<<<blocks, gp::THREADS, 0, s>>>(t, W, C, ix, R, vec4, o);
  } else if (kind == 3) {
    dim3 grid((C + gp::TC - 1) / gp::TC, (R + gp::TR - 1) / gp::TR);
    gp::onehot_matmul<<<grid, gp::THREADS, 0, s>>>(t, W, C, ix, R, o);
  } else {
    return -1;
  }
  const cudaError_t last = cudaGetLastError();   // read (and clear) it
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // extern "C"
