// The element restriction's transpose (the owner-sum, E^T) for NVIDIA Hopper
// (sm_90a): out[c, n] = sum of ve[c, p] over the E-vector positions p that
// reference node n.
//
// Replaces no TPU kernel: the JAX package's restriction transpose is K
// jnp.take gathers of padded (nodes, K) index blocks added in order, which
// XLA fuses (ceedpetscsolid_tpu/ops/restriction.py scatter_add). The port
// ran the same blocks as plain torch on the card, an index_select behind a
// copy that appended a zero column, then a sum over K: ~200 MB of traffic
// and up to ten launches a call. This is one launch.
//
// Layout: ve is contiguous (ncomp, nelem, P3), `plane` = nelem * P3 values a
// component; out is contiguous (ncomp, num_nodes). The table is CSR, built
// once on the host (ops/restriction.csr_table): node n's positions in the
// flattened (nelem, P3) plane are positions[offsets[n] .. offsets[n + 1]),
// ascending. Every position appears exactly once in the table, so each
// E-vector value is read once.
//
// Determinism: one thread a (node, block of components). It walks its
// node's positions once, in ascending order, and keeps four running sums a
// component, started at +0.0: the k-th position of the node (from 0) adds
// into sum k mod 4; the node's value is (s0 + s1) + (s2 + s3), written
// once. No atomics, so the operator CG sees is the same on every
// application, and the result is bit for bit that order's sum (additions
// alone, nothing to contract into an FMA). At a lattice vertex's eight
// positions that is a tree of depth 3, so the rounding is bounded by
// 3 u sum|v| and not by the 7 u of one running sum. With one running sum,
// phase 12's float32 hyperFSIncomp clamp (chip_smoke.py) took a Newton
// step more than its float64 twin; with the padded blocks' sum over K, or
// with this order, it takes the twin's count.
//
// What bounds it on this card: bytes. At 28^3 p4 (21,952 elements of 125
// values, 1,442,897 nodes, three components in float32) it reads the 32.9 MB
// E-vector, 11 MB of positions and 5.8 MB of offsets and writes the 17.3 MB
// L-vector: ~67 MB, ~20 us at 3.35 TB/s. Design responses:
//   * the E-vector that the fused J.v has just written is read through the
//     read-only path (ld.global.nc) while it is still in the 50 MB L2;
//   * a thread takes up to four components (CB), so a node's positions are
//     read once for a vector field and twice for the eight diagnostics;
//   * neighbouring threads take neighbouring nodes, so the offsets, the
//     positions of a run of nodes and the output rows are read and written
//     by coalesced accesses; on a lattice numbering a warp's 32 nodes lie in
//     a few neighbouring elements, so its value loads share sectors;
//   * the position loop steps by four, one load into each running sum, so
//     four loads are in flight together while each sum keeps its order;
//   * 256 threads a block: 5,637 blocks at 28^3 p4 fill the 132 SMs in
//     several waves, 8 blocks an SM.

#include <cuda_runtime.h>

namespace cps_restr {

constexpr int kThreads = 256;
constexpr int kMaxCB = 4;

template <typename T, int CB>
__global__ void __launch_bounds__(kThreads)
    csr_gather_sum(const T* __restrict__ ve, long long plane,
                   const int* __restrict__ offsets,
                   const int* __restrict__ positions, int num_nodes,
                   int ncomp, T* __restrict__ out) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= num_nodes) return;
  const int c0 = blockIdx.y * CB;
  const int nc = ncomp - c0 < CB ? ncomp - c0 : CB;
  const T* v = ve + c0 * plane;
  const int a = __ldg(offsets + n), b = __ldg(offsets + n + 1);
  T s[4][CB];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < CB; ++i) s[j][i] = T(0);
  int k = a;
  for (; k + 4 <= b; k += 4) {
    long long p[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = __ldg(positions + k + j);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < CB; ++i)
        if (i < nc) s[j][i] += __ldg(v + i * plane + p[j]);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (k + j >= b) break;
    const long long p = __ldg(positions + k + j);
#pragma unroll
    for (int i = 0; i < CB; ++i)
      if (i < nc) s[j][i] += __ldg(v + i * plane + p);
  }
  T* o = out + static_cast<long long>(c0) * num_nodes + n;
#pragma unroll
  for (int i = 0; i < CB; ++i)
    if (i < nc)
      o[static_cast<long long>(i) * num_nodes] =
          (s[0][i] + s[1][i]) + (s[2][i] + s[3][i]);
}

template <typename T>
cudaError_t launch(const void* ve, long long plane, const int* offsets,
                   const int* positions, int num_nodes, int ncomp, void* out,
                   cudaStream_t stream) {
  const int cb = ncomp < kMaxCB ? ncomp : kMaxCB;
  const dim3 grid((num_nodes + kThreads - 1) / kThreads,
                  (ncomp + cb - 1) / cb);
  const T* in = static_cast<const T*>(ve);
  T* o = static_cast<T*>(out);
  switch (cb) {
    case 1:
      csr_gather_sum<T, 1><<<grid, kThreads, 0, stream>>>(
          in, plane, offsets, positions, num_nodes, ncomp, o);
      break;
    case 2:
      csr_gather_sum<T, 2><<<grid, kThreads, 0, stream>>>(
          in, plane, offsets, positions, num_nodes, ncomp, o);
      break;
    case 3:
      csr_gather_sum<T, 3><<<grid, kThreads, 0, stream>>>(
          in, plane, offsets, positions, num_nodes, ncomp, o);
      break;
    default:
      csr_gather_sum<T, 4><<<grid, kThreads, 0, stream>>>(
          in, plane, offsets, positions, num_nodes, ncomp, o);
  }
  return cudaGetLastError();
}

}  // namespace cps_restr

extern "C" {

// ve: contiguous (ncomp, plane) of float32 (is_double 0) or float64 (1);
// offsets: int32 (num_nodes + 1,); positions: int32 (offsets[num_nodes],)
// into [0, plane); out: contiguous (ncomp, num_nodes) of ve's type. Launches
// on `stream` and returns cudaGetLastError() (0 on success), or -1 for
// arguments the kernel does not take (no launch then).
int cps_owner_sum(int is_double, const void* ve, long long plane,
                  const void* offsets, const void* positions, int num_nodes,
                  int ncomp, void* out, void* stream) {
  if (num_nodes <= 0 || ncomp <= 0 || plane <= 0 ||
      (ncomp + cps_restr::kMaxCB - 1) / cps_restr::kMaxCB > 65535)
    return -1;
  const int* off = static_cast<const int*>(offsets);
  const int* pos = static_cast<const int*>(positions);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_double ? cps_restr::launch<double>(ve, plane, off, pos, num_nodes,
                                            ncomp, out, s)
                : cps_restr::launch<float>(ve, plane, off, pos, num_nodes,
                                           ncomp, out, s));
}

}  // extern "C"
