// The K = 1 descent of one query through one tree, with multi-probe
// alternates: the code kernels A (forest_traverse.cu, the tree in device
// memory) and F (forest_traverse_smem.cu, the tree in shared memory) share,
// so the two are bitwise equal by construction.
//
// tree reads one tree's feat / thresh / child_base (GlobalTree or
// SharedTree, below), qb points at the query's row, o at its P output
// slots.  Probe 0 is the primary leaf; probe p >= 1 descends with the decision flipped
// at the p-th smallest key (margin |q[feat] - thresh|, depth) of the
// primary path, so ties go to the shallower depth; a NaN or infinite
// margin is never taken, and a slot is -1 once no finite margin is left.
// The float operations are the reference's exactly (`xv >= t`, and
// `fabsf(xv - t)` only at internal nodes, nothing to contract into an FMA).
//
// What the design does about a descent's latency.  A level's child_base,
// feat and thresh are loaded together (a node index is always in range),
// then q[feat]: two dependent loads a level.  No per-level array: the
// primary pass keeps its NA smallest keys in registers, sorted, each with
// its alternate's start (the flipped child of the path node at that
// depth), so there is no depth cap.  The NA alternates then run
// interleaved from their flips, their loads in flight together: the chain
// is the primary's levels plus the deepest alternate's levels below its
// flip, not the sum of the P descents.  P - 1 > NA alternates come in
// rounds, each a primary pass that keeps the next NA keys after the last
// key of the round before (kernels/common.py topk_rounds does the same for
// a top-k), then its alternates.
#pragma once
#include <math.h>

// alternates a thread keeps in registers for P probes (a template
// argument of the kernels); more come in rounds
__host__ __device__ inline int alternates_kept(int P) {
  return P <= 1 ? 0 : P == 2 ? 1 : P <= 4 ? 3 : 7;
}

// A tree behind one call: node(n, ...) loads node n's child_base, thresh
// and feat together, from device memory (GlobalTree, kernel A) or shared
// memory (SharedTree, kernel F).
struct GlobalTree {
  const int* f;
  const float* th;
  const int* cb;
  __device__ __forceinline__ void node(int n, int& c, float& t, int& fe) const {
    c = __ldg(cb + n);
    t = __ldg(th + n);
    fe = __ldg(f + n);
  }
};

struct SharedTree {
  const int* f;
  const float* th;
  const int* cb;
  __device__ __forceinline__ void node(int n, int& c, float& t, int& fe) const {
    c = cb[n];
    t = th[n];
    fe = f[n];
  }
};

// One primary pass: returns the leaf, and leaves in km / kt / kn the NA
// smallest keys (margin, depth) after the exclusive lower key (lo_m, lo_t),
// ascending, with each alternate's start node; +inf where fewer are left.
template <int NA, class Tree>
__device__ __forceinline__ int primary_pass(const Tree& tree, const float* __restrict__ qb,
                                            int max_depth,
                                            float lo_m, int lo_t, float (&km)[NA > 0 ? NA : 1],
                                            int (&kt)[NA > 0 ? NA : 1],
                                            int (&kn)[NA > 0 ? NA : 1]) {
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    km[j] = INFINITY;
    kt[j] = 0;
    kn[j] = 0;
  }
  int node = 0;
  for (int t = 0; t < max_depth; ++t) {
    int cb, f;
    float th;
    tree.node(node, cb, th, f);
    if (cb < 0) break;  // at a leaf: every deeper level keeps the node
    const float xv = qb[f];
    const bool right = xv >= th;
    if (NA > 0) {
      float m = fabsf(xv - th);
      // only finite margins after the lower key (depths rise along the
      // path, so a later equal margin sorts after the ones kept: strict <)
      if (!(m < INFINITY) || !(m > lo_m || (m == lo_m && t > lo_t))) m = INFINITY;
      const int start = cb + (right ? 0 : 1);
      bool c[NA > 0 ? NA : 1];
#pragma unroll
      for (int j = 0; j < NA; ++j) c[j] = m < km[j];
#pragma unroll
      for (int j = NA - 1; j > 0; --j) {
        if (c[j - 1]) {
          km[j] = km[j - 1];
          kt[j] = kt[j - 1];
          kn[j] = kn[j - 1];
        } else if (c[j]) {
          km[j] = m;
          kt[j] = t;
          kn[j] = start;
        }
      }
      if (c[0]) {
        km[0] = m;
        kt[0] = t;
        kn[0] = start;
      }
    }
    node = cb + (right ? 1 : 0);
  }
  return node;
}

// The alternates of one round, interleaved: alternate j starts at kn[j], the
// level below its flip depth kt[j], and ends in kn[j] at its leaf or at
// max_depth levels from the root.  Slots with km[j] = +inf are left alone.
template <int NA, class Tree>
__device__ __forceinline__ void alternates(const Tree& tree, const float* __restrict__ qb,
                                           int max_depth,
                                           const float (&km)[NA], const int (&kt)[NA],
                                           int (&kn)[NA]) {
  int dep[NA];
  bool live[NA];
  bool any = false;
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    dep[j] = kt[j] + 1;
    live[j] = km[j] < INFINITY && dep[j] < max_depth;
    any |= live[j];
  }
  while (any) {
    int cb[NA], f[NA];
    float th[NA], xv[NA];
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      cb[j] = -1;
      if (live[j]) tree.node(kn[j], cb[j], th[j], f[j]);
    }
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      live[j] = live[j] && cb[j] >= 0;
      xv[j] = live[j] ? qb[f[j]] : 0.f;
    }
    any = false;
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      if (live[j]) {
        kn[j] = cb[j] + (xv[j] >= th[j] ? 1 : 0);
        live[j] = ++dep[j] < max_depth;
      }
      any |= live[j];
    }
  }
}

template <int NA, class Tree>
__device__ __forceinline__ void descend_one(const Tree& tree, const float* __restrict__ qb,
                                            int* __restrict__ o, int max_depth, int P) {
  constexpr int NK = NA > 0 ? NA : 1;
  float km[NK];
  int kt[NK], kn[NK];
  o[0] = primary_pass<NA>(tree, qb, max_depth, -1.f, 0, km, kt, kn);
  if constexpr (NA > 0) {
    for (int done = 1; done < P;) {
      alternates<NA>(tree, qb, max_depth, km, kt, kn);
#pragma unroll
      for (int j = 0; j < NA; ++j)
        if (done + j < P) o[done + j] = km[j] < INFINITY ? kn[j] : -1;
      done += NA;
      if (done >= P) break;
      if (!(km[NA - 1] < INFINITY)) {  // no finite margin left
        for (; done < P; ++done) o[done] = -1;
        break;
      }
      const float lo_m = km[NA - 1];
      const int lo_t = kt[NA - 1];
      primary_pass<NA>(tree, qb, max_depth, lo_m, lo_t, km, kt, kn);
    }
  }
}

// descend_one<alternates_kept(P)> for a kernel templated on NA:
// DESCENT_DISPATCH(P, LAUNCH) expands LAUNCH(NA) for the P given
#define DESCENT_DISPATCH(P, LAUNCH)      \
  switch (alternates_kept(P)) {          \
    case 0: LAUNCH(0); break;            \
    case 1: LAUNCH(1); break;            \
    case 3: LAUNCH(3); break;            \
    default: LAUNCH(7); break;           \
  }
