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
//                      -> gather_loop: a flat grid over the output's 16-byte
//                         pieces, U a thread, each thread reading its rows'
//                         indices itself; the table read with an L2
//                         evict_last hint, the output stored streaming;
//   K6 k_onehot (:85)  one-hot (R, W) @ (W, C) on the MXU
//                      -> gather_onehot: the product's value without the
//                         product: blocks (a cluster of them for a tall
//                         table) count the non-finite values of each table
//                         column while they gather their rows.
// The wrapper (ops/gather_probe.py) checks shapes, types and contiguity and
// makes each kernel's launch plan (plan, loop_plan, onehot_plan).
//
// Index contract. For any int32 index each kernel gives what the JAX op of
// its TPU body gives, W being the table's rows:
//   K3, K4 (jnp.take / take_along_axis, default "fill" mode): a negative
//     index wraps once (i + W); an index still outside [0, W) gives a row of
//     the canonical quiet NaN, 0x7fc00000;
//   K5 (pl.ds, a lax.dynamic_slice): wrap once, then clamp into [0, W - 1];
//   K6 (iota == idx, then the product): the one-hot product. An index j
//     outside [0, W) matches no row, so out[r, c] sums 0 * tab[w, c] over
//     every w. 0 * inf and 0 * NaN are NaN, so:
//       out[r, c] = NaN               if column c holds a non-finite value
//                                     at a row w != j, or tab[j, c] is NaN;
//                 = tab[j, c] + 0.0f  otherwise, j in range (-0.0 becomes
//                                     +0.0; an inf survives only in the row
//                                     that selects it);
//                 = +0.0              otherwise, j out of range.
//     Its NaN is 0x7fffffff (CUDA's); the plain product's NaN bits follow
//     its summation order, so K6 is held with NaN positions equal and every
//     other value bitwise.
// K3-K5 copy bits: NaN payloads and -0.0 pass through unchanged, and rows in
// range are bitwise tab[idx].
//
// What bounds them on this card. A gather moves 4*C bytes per output row and
// does no arithmetic. At the probe's shape (512 x 128 table, 256 rows: a 256
// KB table, 128 KB out) the bound is latency: the time until a block's table
// rows are on chip, then one pass of writes. At the production shape
// (200,000 x 32 table, 1,168,128 rows, 150 MB out) the 25.6 MB table sits in
// the 50 MB L2, so the bound is the output write plus the L2 reads. K6 reads
// the whole table whatever the indices: every output value depends on whole
// columns.
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
//   * K5 has no shared memory and no block barrier. The output is a flat
//     run of 16-byte pieces (4-byte ones when C % 4 != 0 or the table is
//     not 16-byte aligned); thread t of a grid of T threads owns pieces t,
//     t + T, ..., U of them, so consecutive lanes write consecutive pieces
//     of a row and every write is coalesced. A thread reads its pieces'
//     row indices itself (lanes of one row read one word: one transaction),
//     wraps and clamps them, issues all U table loads, then all U stores:
//     U independent loads in flight a thread. The wrapper picks U (1, 2, 4
//     or 8) from the pieces against the card's resident threads (132 SMs x
//     2048): U = 1 and 32 blocks at the probe's shape, so 32 SMs share the
//     probe's rows, not one block on one SM; U = 8 at the production shape.
//     Table loads carry an L2 evict_last policy (createpolicy +
//     ld.global.nc.L2::cache_hint) and output stores are streaming (__stcs),
//     so the 150 MB output stream does not push the 25.6 MB table out of L2.
//   * K6 computes the one-hot product's function, not the product, which
//     would spend W multiply-adds per output value, all but one on a zero,
//     in W / 32 barrier rounds. Grid (cs, slabs, groups), cluster
//     (cs, 1, 1): block k of a cluster scans table rows [k rows, (k + 1)
//     rows) of its column slab (4 vectors, 64 bytes a row, by default), a
//     thread one vector column, K6_BATCH coalesced loads in registers
//     before it counts any (counting each load as it arrives costs one L2
//     round trip a row), counting the non-finite values of each column in
//     registers, then once into shared memory (slab ints: any table size
//     fits). Each thread first loads the indices of its first K6_PRE output
//     pieces, and their tab[j] pieces once the scan's loads are issued, so
//     the gather is in flight through the barriers. Then cluster.sync(),
//     the block sums the cluster's counts through map_shared_rank, and
//     each output value follows from its column's count, whether tab[j, c]
//     is itself non-finite, and whether j is in range; a last
//     cluster.sync() keeps the counts alive for their readers. The wrapper
//     takes the fewest blocks a cluster (1, 2, 4, 8) whose rows a thread
//     scans in one batch: a one-block cluster is a plain launch, whose
//     barriers are the block's own, and at the probe's shape (512 rows)
//     that is 32 single blocks, 8 slabs x 4 groups, one output piece a
//     thread; a taller table spreads its rows over a cluster. groups
//     spreads the output rows (at most 128 blocks in all); each group
//     reads its slabs of the table once, from L2.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace gp {

constexpr int THREADS = 256;
constexpr int CHUNK = 256;            // K3/K4: output rows staged at a time
constexpr int K6_MAX_NV = 32;         // K6: vectors of a column slab
constexpr int K6_PRE = 4;             // K6: pieces a thread gathers early
constexpr int K6_BATCH = 8;           // K6: scan loads in flight a thread
constexpr unsigned QNAN = 0x7fc00000u;      // jnp.take's fill value
constexpr unsigned CUDA_NAN = 0x7fffffffu;  // K6's NaN

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

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------
// An L2 policy that keeps what it loads: evict_last for the whole access.
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// Read-only loads that carry an L2 cache policy.
__device__ __forceinline__ float4 load_keep(const float4* p, uint64_t pol) {
  float4 v;
  asm volatile(
      "ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ float load_keep(const float* p, uint64_t pol) {
  float v;
  asm volatile("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
               : "=f"(v)
               : "l"(p), "l"(pol));
  return v;
}

// K5: out (pieces of V, CV a row) = tab[clamp(wrap(idx[row]))], U pieces a
// thread at stride gridDim.x * THREADS: see the header. pieces = R * CV <
// 2^31 (the wrapper's check), so every piece number fits 32 bits unsigned.
template <typename V, int U>
__global__ void __launch_bounds__(THREADS)
slice_rows(const V* __restrict__ tab, int W, int CV,
           const int* __restrict__ idx, unsigned pieces, V* __restrict__ out) {
  const uint64_t keep = evict_last_policy();
  const unsigned T = gridDim.x * THREADS;
  const unsigned p0 = blockIdx.x * THREADS + threadIdx.x;
  int j[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const unsigned p = p0 + u * T;
    int i = p < pieces ? __ldg(idx + p / CV) : 0;
    if (i < 0) i += W;          // wrap once, then clamp into [0, W - 1]
    j[u] = min(max(i, 0), W - 1);
  }
  V x[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const unsigned p = p0 + u * T;
    if (p < pieces) x[u] = load_keep(tab + (size_t)j[u] * CV + p % CV, keep);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const unsigned p = p0 + u * T;
    if (p < pieces) __stcs(out + p, x[u]);
  }
}

// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------
__device__ __forceinline__ float& lane(float& v, int) { return v; }
__device__ __forceinline__ float& lane(float4& v, int k) {
  return (&v.x)[k];
}

__device__ __forceinline__ int nonfinite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) == 0x7f800000u;
}

// K6: the one-hot product's value from the table's per-column counts of
// non-finite values: see the header. Block (rank, slab, group): the slab's
// vector columns [v0, v0 + nvs) of CV, table rows [rank rows, (rank + 1)
// rows) scanned, its share of the group's output rows written.
template <typename V>
__global__ void __launch_bounds__(THREADS)
onehot_scan(const V* __restrict__ tab, int W, int CV,
            const int* __restrict__ idx, int R, int rows, int nv,
            int rows_per_cluster, V* __restrict__ out) {
  constexpr int VW = sizeof(V) / sizeof(float);
  __shared__ int cnt[K6_MAX_NV * VW];   // this block's counts, per column
  __shared__ int tot[K6_MAX_NV * VW];   // the cluster's
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int v0 = blockIdx.y * nv;
  const int nvs = min(nv, CV - v0);     // the last slab may be narrower
  for (int i = threadIdx.x; i < nvs * VW; i += THREADS) cnt[i] = 0;

  // this block's output pieces: rows [r0, r0 + nr) x nvs vectors
  const int g0 = blockIdx.z * rows_per_cluster;
  const int gn = min(rows_per_cluster, R - g0);
  const int per = (gn + cs - 1) / cs;
  const int r0 = g0 + rank * per;
  const int nr = max(0, min(per, g0 + gn - r0));
  const int n = nr * nvs;
  // the first K6_PRE pieces a thread: their indices now, their tab[j]
  // pieces once the scan's loads are issued (an index outside [0, W) loads
  // nothing and stands for +0.0, which the rule below turns into the sum
  // of the column's zeros)
  auto gather = [&](int e, int j) {
    return (unsigned)j < (unsigned)W
               ? __ldg(tab + (size_t)j * CV + v0 + e % nvs)
               : V{};
  };
  int jj[K6_PRE];
#pragma unroll
  for (int u = 0; u < K6_PRE; ++u) {
    const int e = threadIdx.x + u * THREADS;
    jj[u] = e < n ? __ldg(idx + r0 + e / nvs) : -1;
  }

  // scan: table rows [w0, w0 + nw), a thread one vector column, `step`
  // rows apart, K6_BATCH loads in registers before any is counted (a loop
  // that counts each load as it comes waits one L2 round trip a row)
  const int w0 = rank * rows;
  const int nw = max(0, min(rows, W - w0));
  const int step = THREADS / nvs;
  const int v = threadIdx.x % nvs, w1 = threadIdx.x / nvs;
  int c[VW];
#pragma unroll
  for (int k = 0; k < VW; ++k) c[k] = 0;
  if (w1 < step) {
    const V* col = tab + (size_t)w0 * CV + v0 + v;
    for (int w = w1; w < nw; w += K6_BATCH * step) {
      V x[K6_BATCH];
#pragma unroll
      for (int b = 0; b < K6_BATCH; ++b) {
        const int wb = w + b * step;
        x[b] = wb < nw ? __ldg(col + (size_t)wb * CV) : V{};
      }
#pragma unroll
      for (int b = 0; b < K6_BATCH; ++b)
#pragma unroll
        for (int k = 0; k < VW; ++k) c[k] += nonfinite(lane(x[b], k));
    }
  }
  V g[K6_PRE];                          // in flight through the barriers
#pragma unroll
  for (int u = 0; u < K6_PRE; ++u)
    g[u] = gather(threadIdx.x + u * THREADS, jj[u]);
  __syncthreads();                      // cnt is zeroed
  if (w1 < step) {
#pragma unroll
    for (int k = 0; k < VW; ++k)
      if (c[k]) atomicAdd(&cnt[v * VW + k], c[k]);
  }
  cluster.sync();                       // every block's counts are in
  for (int i = threadIdx.x; i < nvs * VW; i += THREADS) {
    int s = 0;
    for (int k = 0; k < cs; ++k) s += cluster.map_shared_rank(cnt, k)[i];
    tot[i] = s;
  }
  __syncthreads();

  // out = NaN where a non-finite value of the column sits at another row,
  // else tab[j, c] + 0.0f (NaN when tab[j, c] is; +0.0 out of range)
  auto emit = [&](int e, V x) {
    const int col = (e % nvs) * VW;
    V y;
#pragma unroll
    for (int k = 0; k < VW; ++k) {
      const float a = lane(x, k);
      lane(y, k) = tot[col + k] - nonfinite(a) > 0 ? __uint_as_float(CUDA_NAN)
                                                   : __fadd_rn(a, 0.0f);
    }
    out[(size_t)(r0 + e / nvs) * CV + v0 + e % nvs] = y;
  };
#pragma unroll
  for (int u = 0; u < K6_PRE; ++u) {
    const int e = threadIdx.x + u * THREADS;
    if (e < n) emit(e, g[u]);
  }
  for (int e = threadIdx.x + K6_PRE * THREADS; e < n; e += THREADS)
    emit(e, gather(e, __ldg(idx + r0 + e / nvs)));
  cluster.sync();                       // readers of this block's cnt are done
}

// One thread-block cluster launch: grid `grid`, cluster (cs, 1, 1); at
// cs = 1 a plain launch (every grid is then a grid of one-block clusters).
template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, dim3 grid, int cs,
                           size_t smem, cudaStream_t s, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename V>
cudaError_t launch_take(const float* t, int W, int C, const int* ix, int R,
                        float* o, int cs, int rows, int slab, int groups,
                        int rows_per_cluster, cudaStream_t s) {
  return launch_cluster(cluster_take<V>, dim3(cs, C / slab, groups), cs,
                        staged_smem(rows, slab), s, t, W, C, ix, R, rows, slab,
                        rows_per_cluster, o);
}

// K6 with the plan of ops/gather_probe.onehot_plan: `slab` columns a slab
// (a multiple of the vector width).
template <typename V>
cudaError_t launch_onehot(const float* t, int W, int C, const int* ix, int R,
                          float* o, int cs, int rows, int slab, int groups,
                          int rows_per_cluster, cudaStream_t s) {
  constexpr int VW = sizeof(V) / sizeof(float);
  const int nv = slab / VW, CV = C / VW;
  if (nv < 1 || nv > K6_MAX_NV || slab % VW) return cudaErrorInvalidValue;
  return launch_cluster(onehot_scan<V>, dim3(cs, (CV + nv - 1) / nv, groups),
                        cs, 0, s, reinterpret_cast<const V*>(t), W, CV, ix, R,
                        rows, nv, rows_per_cluster, reinterpret_cast<V*>(o));
}

// K5 with the plan of ops/gather_probe.loop_plan: `blocks` blocks, U pieces
// a thread.
template <typename V>
cudaError_t launch_loop(const float* t, int W, int C, const int* ix, int R,
                        float* o, int blocks, int U, cudaStream_t s) {
  constexpr int VW = sizeof(V) / sizeof(float);
  const int CV = C / VW;
  void (*kernel)(const V*, int, int, const int*, unsigned, V*) =
      U == 1   ? slice_rows<V, 1>
      : U == 2 ? slice_rows<V, 2>
      : U == 4 ? slice_rows<V, 4>
      : U == 8 ? slice_rows<V, 8>
               : nullptr;
  if (kernel == nullptr) return cudaErrorInvalidValue;
  kernel<<<blocks, THREADS, 0, s>>>(reinterpret_cast<const V*>(t), W, CV, ix,
                                    static_cast<unsigned>(R) * CV,
                                    reinterpret_cast<V*>(o));
  return cudaSuccess;
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

// kind: 0 take, 1 take_along_axis, 2 loop, 3 onehot; plan args from
// ops/gather_probe:
//   kinds 0-1 (plan): cluster size cs, table rows a block holds, slab
//     columns (a multiple of 4 dividing C), groups of clusters along the
//     output rows and rows per cluster; tab 16-byte aligned;
//   kind 2 (loop_plan): `groups` blocks, `per_thread` pieces a thread (1, 2,
//     4 or 8);
//   kind 3 (onehot_plan): cs, rows, slab columns (at most 32 vectors),
//     groups and rows per cluster as for kinds 0-1.
// vec4 (kinds 2-3): 16-byte pieces (C % 4 == 0 and tab 16-byte aligned),
// else 4-byte ones. Returns the launch's cudaError_t, then
// cudaGetLastError() (0 on success), or -1 for an unknown kind.
int cps_gather_probe(int kind, const void* tab, int W, int C, const void* idx,
                     int R, void* out, int cs, int rows, int slab, int groups,
                     int rows_per_cluster, int per_thread, int vec4,
                     void* stream) {
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
    e = vec4 ? gp::launch_loop<float4>(t, W, C, ix, R, o, groups, per_thread, s)
             : gp::launch_loop<float>(t, W, C, ix, R, o, groups, per_thread, s);
  } else if (kind == 3) {
    e = vec4 ? gp::launch_onehot<float4>(t, W, C, ix, R, o, cs, rows, slab,
                                         groups, rows_per_cluster, s)
             : gp::launch_onehot<float>(t, W, C, ix, R, o, cs, rows, slab,
                                        groups, rows_per_cluster, s);
  } else {
    return -1;
  }
  const cudaError_t last = cudaGetLastError();   // read (and clear) it
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // extern "C"
