// K2: the lane-batched narrowphase on Hopper (sm_90a).
//
// Replaces the TPU kernel solver2d_tpu/ops/narrow_pallas.py:_kernel (launched
// by collide_lanes_pallas), whose math is ops/narrow_lanes.py:collide_lanes.
// One thread per (world, contact): warm-started GJK with at most a fixed
// number of trips and a 3-vertex simplex cache in and out, SAT max
// separation, reference / incident edge clipping into a manifold of at most
// 2 points with feature ids, and the circle paths (reference:
// src/distance.c:91-636, src/manifold.c:16-650).
//
// Design. A block covers a tile of TX contact slots times TW worlds
// (kLaneTX x kLaneTW, 32 x 8, when the batch has 8 worlds or more, else
// 128 x 1; the per-world step flattens its worlds into one lane batch,
// W = 1). All worlds
// collide the same shape pair in a slot, so the block first stages the two
// geometry rows of each of its TX slots (34 floats each) into shared memory,
// once for its TW worlds, in SoA layout: field k of slot x at [k * TX + x].
// A thread reads its own slot's column, so every read, also one indexed by
// a vertex or edge number, falls in bank x % 32 and a warp never conflicts.
// Indexed shared reads replace the select chains that registers needed, and
// the register file no longer holds the rows: __launch_bounds__ asks for
// 1024 threads an SM, which caps registers at 64 a thread. B's vertices
// and normals in A's frame are recomputed from the staged row where they
// are read, by the expression the twin uses, so they round alike.
// Neighbouring threads take neighbouring slots of one world, so poses
// [W, 4, C] and caches [W, 7, C] are read, and outputs [W, 12|3|7, C]
// written, coalesced; a thread issues its pose and cache loads before the
// staging barrier, so their latency passes while the block stages. The
// scans take one row at a time. On an H100 each of these choices was the
// fastest of its variants (lane tiles 32 x 4, 32 x 16 and 64 x 2; scans of
// 2, 4 and 8 rows together; loads after the barrier; B kept in shared
// memory), and a tighter register cap won 1% only with spills (PERF.md,
// section 6).
// GJK leaves its loop as soon as the simplex is done:
// the twin's later trips write nothing then, so the result is the same.
// The scans over a shape's vertices and edges stop at its count: the masked
// rows of the twin's fixed 8-row scans never win a first-max or first-min
// (their scores are -inf or -/+1e30). Only the manifold path a contact takes
// is computed; the plain twin computes every path and selects.
//
// Numbers. The operation order is that of the plain twin
// (solver2d_tpu_torch/ops/narrow_lanes.py); built with -fmad=false and IEEE
// division and square root, the kernel rounds as the twin does on the card,
// so ties in the argmax/argmin scans break alike and the integer outputs
// (feature ids, point counts, GJK caches) agree exactly. An index read from
// the cache is taken as the twin's select chain takes it: 0 when outside
// [0, 8).
//
// Bound. Per (world, contact) the function reads 60 bytes (two poses, the
// cache) and writes 88 (12 floats, 3 + 7 ints); at the lane path's 512
// worlds x 7936 contacts that is ~0.6 GB, ~0.18 ms at 3.35 TB/s. The float
// work (the GJK trips this data needs, and the one manifold path a slot
// takes) is below that at the card's 67 TFLOP/s fp32 rate; chip_smoke.py
// counts both for the run's inputs (k2_bytes, k2_ops) and reports the larger
// as the bound. The kernel reaches about 55% of it at the lane shape: what
// holds it is its instruction stream, not memory or occupancy (scoring more
// rows at a time, or more resident warps with spills, was not faster;
// PERF.md section 6).

#include <cuda_runtime.h>
#include <stdint.h>

#define F(x) ((float)(x))

namespace {

constexpr double kEpsD = 1.1920929e-07;
constexpr double kLinearSlop = 0.005;
constexpr double kSpeculative = 4.0 * kLinearSlop;
constexpr int kThreads = 128;  // a per-world block: 128 slots x 1 world
constexpr int kLaneTX = 32;    // a lane block: 32 slots x 8 worlds
constexpr int kLaneTW = 8;
constexpr int kSmThreads = 1024;  // threads an SM that __launch_bounds__ asks for
constexpr int kRow = 34;  // geometry row: vx(8) vy(8) nx(8) ny(8) count radius
constexpr float kBig = 1e30f;

template <typename T>
__device__ __forceinline__ T pick3(T a0, T a1, T a2, int idx) {
  return idx == 2 ? a2 : (idx == 1 ? a1 : a0);
}

// an index as the twin's select chain reads it (rows outside [0, 8) read row 0)
__device__ __forceinline__ int vi(int idx) { return ((unsigned)idx < 8u) ? idx : 0; }

__device__ __forceinline__ void normalize2(float x, float y, float* ox, float* oy, float* len) {
  const float eps = F(1e-12);
  float l = sqrtf(x * x + y * y);
  float inv = (l > eps) ? (1.0f / fmaxf(l, eps)) : 0.0f;
  *ox = x * inv;
  *oy = y * inv;
  *len = l;
}

__device__ __forceinline__ float safe_inv(float x) { return 1.0f / ((x != 0.0f) ? x : 1.0f); }

// reference: src/distance.c:333-474 (simplex solves). w are the Minkowski
// points B - A; fills perm, barycentric weights and the new count.
__device__ __forceinline__ void solve_simplex(int count, const float (&wx)[3], const float (&wy)[3],
                                              int (&perm)[3], float (&a)[3], int* newc) {
  if (count == 1) {
    perm[0] = 0; perm[1] = 1; perm[2] = 2;
    a[0] = 1.0f; a[1] = 0.0f; a[2] = 0.0f;
    *newc = 1;
    return;
  }
  float w0x = wx[0], w0y = wy[0], w1x = wx[1], w1y = wy[1];
  if (count == 2) {
    float e12x = w1x - w0x, e12y = w1y - w0y;
    float d12_2 = -(w0x * e12x + w0y * e12y);
    float d12_1 = w1x * e12x + w1y * e12y;
    float s = d12_1 + d12_2;
    float inv = 1.0f / ((s != 0.0f) ? s : 1.0f);
    bool in_w1 = d12_2 <= 0.0f;
    bool in_w2 = (!in_w1) && (d12_1 <= 0.0f);
    bool vertex = in_w1 || in_w2;
    perm[0] = in_w2 ? 1 : 0; perm[1] = 1; perm[2] = 2;
    a[0] = vertex ? 1.0f : d12_1 * inv;
    a[1] = vertex ? 0.0f : d12_2 * inv;
    a[2] = 0.0f;
    *newc = vertex ? 1 : 2;
    return;
  }
  float w2x = wx[2], w2y = wy[2];
  float e12x = w1x - w0x, e12y = w1y - w0y;
  float d12_1 = w1x * e12x + w1y * e12y;
  float d12_2 = -(w0x * e12x + w0y * e12y);
  float e13x = w2x - w0x, e13y = w2y - w0y;
  float d13_1 = w2x * e13x + w2y * e13y;
  float d13_2 = -(w0x * e13x + w0y * e13y);
  float e23x = w2x - w1x, e23y = w2y - w1y;
  float d23_1 = w2x * e23x + w2y * e23y;
  float d23_2 = -(w1x * e23x + w1y * e23y);
  float n123 = e12x * e13y - e12y * e13x;
  float d123_1 = n123 * (w1x * w2y - w1y * w2x);
  float d123_2 = n123 * (w2x * w0y - w2y * w0x);
  float d123_3 = n123 * (w0x * w1y - w0y * w1x);

  int c;
  if (d12_2 <= 0.0f && d13_2 <= 0.0f) c = 0;
  else if (d12_1 > 0.0f && d12_2 > 0.0f && d123_3 <= 0.0f) c = 1;
  else if (d13_1 > 0.0f && d13_2 > 0.0f && d123_2 <= 0.0f) c = 2;
  else if (d12_1 <= 0.0f && d23_2 <= 0.0f) c = 3;
  else if (d13_1 <= 0.0f && d23_1 <= 0.0f) c = 4;
  else if (d23_1 > 0.0f && d23_2 > 0.0f && d123_1 <= 0.0f) c = 5;
  else c = 6;

  switch (c) {
    case 0: a[0] = 1.0f; a[1] = 0.0f; a[2] = 0.0f; break;
    case 1: { float i12 = safe_inv(d12_1 + d12_2); a[0] = d12_1 * i12; a[1] = d12_2 * i12; a[2] = 0.0f; break; }
    case 2: { float i13 = safe_inv(d13_1 + d13_2); a[0] = d13_1 * i13; a[1] = d13_2 * i13; a[2] = 0.0f; break; }
    case 3: case 4: a[0] = 1.0f; a[1] = 0.0f; a[2] = 0.0f; break;
    case 5: { float i23 = safe_inv(d23_1 + d23_2); a[0] = d23_2 * i23; a[1] = d23_1 * i23; a[2] = 0.0f; break; }
    default: {
      float i123 = safe_inv(d123_1 + d123_2 + d123_3);
      a[0] = d123_1 * i123; a[1] = d123_2 * i123; a[2] = d123_3 * i123;
    }
  }
  // the tables {0, 0, 0, 1, 2, 2, 0}, {1, 1, 2, 1, 1, 1, 1},
  // {2, 2, 1, 2, 2, 0, 2} (perm) and {1, 2, 2, 1, 1, 2, 3} (count) by case,
  // a nibble a case: a shift, not an array in local memory
  const int sh = 4 * c;
  perm[0] = (0x0221000 >> sh) & 15;
  perm[1] = (0x1111211 >> sh) & 15;
  perm[2] = (0x2022122 >> sh) & 15;
  *newc = (0x3211221 >> sh) & 15;
}

struct Simplex {
  float wax[3], way[3], wbx[3], wby[3], bary[3];
  int ia[3], ib[3], count;
};

__device__ __forceinline__ void simplex_solve(Simplex& s) {
  float wx[3], wy[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) { wx[i] = s.wbx[i] - s.wax[i]; wy[i] = s.wby[i] - s.way[i]; }
  int perm[3];
  float a[3];
  int newc;
  solve_simplex(s.count, wx, wy, perm, a, &newc);
  Simplex o;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o.wax[i] = pick3(s.wax[0], s.wax[1], s.wax[2], perm[i]);
    o.way[i] = pick3(s.way[0], s.way[1], s.way[2], perm[i]);
    o.wbx[i] = pick3(s.wbx[0], s.wbx[1], s.wbx[2], perm[i]);
    o.wby[i] = pick3(s.wby[0], s.wby[1], s.wby[2], perm[i]);
    o.ia[i] = pick3(s.ia[0], s.ia[1], s.ia[2], perm[i]);
    o.ib[i] = pick3(s.ib[0], s.ib[1], s.ib[2], perm[i]);
    o.bary[i] = a[i];
  }
  o.count = newc;
  s = o;
}

// One thread's view of its slot's two staged geometry rows, and of B moved
// into A's frame (reference: src/manifold.c:515-525).
template <int TX>
struct Geo {
  const float* sg;  // this slot's column of the staged rows: field k at sg[k * TX]
  float xqs, xqc, xpx, xpy;
  int ca, cb;
  float ra, rb;

  __device__ __forceinline__ float at(int k) const { return sg[k * TX]; }
  __device__ __forceinline__ float ax(int j) const { return at(j); }
  __device__ __forceinline__ float ay(int j) const { return at(8 + j); }
  __device__ __forceinline__ float nax(int j) const { return at(16 + j); }
  __device__ __forceinline__ float nay(int j) const { return at(24 + j); }
  __device__ __forceinline__ float bx(int j) const { return xpx + (xqc * at(kRow + j) - xqs * at(kRow + 8 + j)); }
  __device__ __forceinline__ float by(int j) const { return xpy + (xqs * at(kRow + j) + xqc * at(kRow + 8 + j)); }
  __device__ __forceinline__ float nbx(int j) const { return xqc * at(kRow + 16 + j) - xqs * at(kRow + 24 + j); }
  __device__ __forceinline__ float nby(int j) const { return xqs * at(kRow + 16 + j) + xqc * at(kRow + 24 + j); }
  // A's (side 0) or B's (side 1) vertex and normal
  __device__ __forceinline__ float vx(bool side_b, int j) const { return side_b ? bx(j) : ax(j); }
  __device__ __forceinline__ float vy(bool side_b, int j) const { return side_b ? by(j) : ay(j); }
  __device__ __forceinline__ float nx(bool side_b, int j) const { return side_b ? nbx(j) : nax(j); }
  __device__ __forceinline__ float ny(bool side_b, int j) const { return side_b ? nby(j) : nay(j); }
  __device__ __forceinline__ int count(bool side_b) const { return side_b ? cb : ca; }
};

// The twin's scans run over all 8 rows of a shape, rows >= its count
// scored with a mask value that never wins. These stop at the count.

// running first max (strict >) of score(j), rows >= n scored `mask`
template <class Score>
__device__ __forceinline__ int first_max(int n, float mask, Score score, float* best) {
  int bi = 0;
  float bs = (n > 0) ? score(0) : mask;
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    if (j >= n) break;
    const float v = score(j);
    if (v > bs) {
      bi = j;
      bs = v;
    }
  }
  *best = bs;
  return bi;
}

// running fminf of score(j) from row 0, rows >= n scored +1e30
template <class Score>
__device__ __forceinline__ float min_over(int n, Score score) {
  float b = (n > 0) ? score(0) : kBig;
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    if (j >= n) break;
    b = fminf(b, score(j));
  }
  return b;
}

// first-max support index (reference: src/distance.c:116-131)
template <int TX>
__device__ __forceinline__ int support(const Geo<TX>& g, bool side_b, float dx, float dy) {
  float best;
  return first_max(g.count(side_b), -__int_as_float(0x7f800000),
                   [&](int j) { return g.vx(side_b, j) * dx + g.vy(side_b, j) * dy; }, &best);
}

// reference: src/manifold.c:402-438. Side 1's edges against side 2's
// vertices: the edge (first max) of the largest least separation.
template <int TX>
__device__ __forceinline__ float find_max_sep(const Geo<TX>& g, bool b1, int* edge) {
  const int n2 = g.count(!b1);
  float best;
  *edge = first_max(g.count(b1), -kBig, [&](int i) {
    const float n1x = g.nx(b1, i), n1y = g.ny(b1, i);
    const float rowdot = n1x * g.vx(b1, i) + n1y * g.vy(b1, i);
    return min_over(n2, [&](int j) { return (n1x * g.vx(!b1, j) + n1y * g.vy(!b1, j)) - rowdot; });
  }, &best);
  return best;
}

// the most anti-parallel edge of a side (first min; reference:
// src/manifold.c:456-489)
template <int TX>
__device__ __forceinline__ int incident_edge(const Geo<TX>& g, bool side_b, float sdx, float sdy) {
  float best;
  return first_max(g.count(side_b), -kBig, [&](int j) { return -(g.nx(side_b, j) * sdx + g.ny(side_b, j) * sdy); },
                   &best);
}

struct Clip {
  float nx, ny, p0x, p0y, p1x, p1y, s0, s1;
  int id0, id1;
};

// reference: src/manifold.c:248-399
template <int TX>
__device__ __forceinline__ Clip clip_polygons(const Geo<TX>& g, int edge_a, int edge_b, bool flip) {
  const float eps = F(kEpsD);
  int i11 = flip ? edge_b : edge_a;
  int cnt1 = flip ? g.cb : g.ca;
  int i12 = (i11 + 1 < cnt1) ? i11 + 1 : 0;
  int i21 = flip ? edge_a : edge_b;
  int cnt2 = flip ? g.ca : g.cb;
  int i22 = (i21 + 1 < cnt2) ? i21 + 1 : 0;

  // side 1 is B when flipped
  float nx = g.nx(flip, vi(i11));
  float ny = g.ny(flip, vi(i11));
  float v11x = g.vx(flip, vi(i11)), v11y = g.vy(flip, vi(i11));
  float v12x = g.vx(flip, vi(i12)), v12y = g.vy(flip, vi(i12));
  float v21x = g.vx(!flip, vi(i21)), v21y = g.vy(!flip, vi(i21));
  float v22x = g.vx(!flip, vi(i22)), v22y = g.vy(!flip, vi(i22));
  float r1 = flip ? g.rb : g.ra;
  float r2 = flip ? g.ra : g.rb;

  float tx = -ny, ty = nx;
  float lower1 = 0.0f;
  float upper1 = (v12x - v11x) * tx + (v12y - v11y) * ty;
  float upper2 = (v21x - v11x) * tx + (v21y - v11y) * ty;
  float lower2 = (v22x - v11x) * tx + (v22y - v11y) * ty;
  float d21 = upper2 - lower2;

  float safe_d21 = (d21 != 0.0f) ? d21 : 1.0f;
  float frac_l = (lower1 - lower2) / safe_d21;
  bool cl = (lower2 < lower1) && (d21 > eps);
  float v_lx = cl ? (v22x + frac_l * (v21x - v22x)) : v22x;
  float v_ly = cl ? (v22y + frac_l * (v21y - v22y)) : v22y;
  float frac_u = (upper1 - lower2) / safe_d21;
  bool cu = (upper2 > upper1) && (d21 > eps);
  float v_ux = cu ? (v22x + frac_u * (v21x - v22x)) : v21x;
  float v_uy = cu ? (v22y + frac_u * (v21y - v22y)) : v21y;

  float sep_l = (v_lx - v11x) * nx + (v_ly - v11y) * ny;
  float sep_u = (v_ux - v11x) * nx + (v_uy - v11y) * ny;

  v_lx = v_lx + (0.5f * ((r1 - r2) - sep_l)) * nx;
  v_ly = v_ly + (0.5f * ((r1 - r2) - sep_l)) * ny;
  v_ux = v_ux + (0.5f * ((r1 - r2) - sep_u)) * nx;
  v_uy = v_uy + (0.5f * ((r1 - r2) - sep_u)) * ny;
  float radius = r1 + r2;

  Clip o;
  o.p0x = flip ? v_ux : v_lx;
  o.p0y = flip ? v_uy : v_ly;
  o.p1x = flip ? v_lx : v_ux;
  o.p1y = flip ? v_ly : v_uy;
  o.s0 = (flip ? sep_u : sep_l) - radius;
  o.s1 = (flip ? sep_l : sep_u) - radius;
  o.id0 = flip ? ((i21 << 8) | i12) : ((i11 << 8) | i22);
  o.id1 = flip ? ((i22 << 8) | i11) : ((i12 << 8) | i21);
  o.nx = flip ? -nx : nx;
  o.ny = flip ? -ny : ny;
  return o;
}

// Stage the geometry rows of the block's TX slots: field k of slot x at
// sg[k * TX + x], rows of A in fields 0-33 and of B in 34-67. Thread t
// stages field pairs t / TX, t / TX + TW, ... of slot t % TX, so it reads
// the slot's two shape indices once, and a row (136 bytes, 8-byte aligned)
// in 8-byte loads; a warp stores one field of 32 slots (no bank met twice).
template <int TX, int TW>
__device__ __forceinline__ void stage_rows(float* sg, const float* __restrict__ geom, const int* __restrict__ sa,
                                           const int* __restrict__ sb, int C, int c0, int t) {
  const int x = t % TX, p0 = t / TX;
  const int c = c0 + x;
  if (c >= C) return;
  const float2* ga = reinterpret_cast<const float2*>(geom + (long long)__ldg(sa + c) * kRow);
  const float2* gb = reinterpret_cast<const float2*>(geom + (long long)__ldg(sb + c) * kRow);
  for (int q = p0; q < kRow / 2; q += TW) {
    const float2 v = __ldg(ga + q);
    sg[2 * q * TX + x] = v.x;
    sg[(2 * q + 1) * TX + x] = v.y;
  }
  for (int q = p0; q < kRow / 2; q += TW) {
    const float2 v = __ldg(gb + q);
    sg[(kRow + 2 * q) * TX + x] = v.x;
    sg[(kRow + 2 * q + 1) * TX + x] = v.y;
  }
}

// A slot's own inputs: the two poses and the GJK cache.
struct SlotIn {
  float pax, pay, qas, qac, pbx, pby, qbs, qbc;
  int cache[7];
};

__device__ __forceinline__ SlotIn load_slot(const float* __restrict__ pa, const float* __restrict__ pb,
                                            const int* __restrict__ cache, int w, int c, int C) {
  SlotIn in;
  const long long p4 = (long long)w * 4 * C + c;
  in.pax = pa[p4]; in.pay = pa[p4 + C]; in.qas = pa[p4 + 2 * C]; in.qac = pa[p4 + 3 * C];
  in.pbx = pb[p4]; in.pby = pb[p4 + C]; in.qbs = pb[p4 + 2 * C]; in.qbc = pb[p4 + 3 * C];
  const long long c7 = (long long)w * 7 * C + c;
#pragma unroll
  for (int r = 0; r < 7; ++r) in.cache[r] = cache[c7 + r * C];
  return in;
}

// One (world, contact) slot; sg points at the slot's column of the staged
// rows.
template <int TX>
__device__ __forceinline__ void collide_slot(const float* sg, const SlotIn& in,
                                             float* __restrict__ fout, int* __restrict__ iout,
                                             int* __restrict__ cout, int w, int c, int C, int gjk_iters) {
  const float eps = F(kEpsD);
  Geo<TX> g;
  g.sg = sg;
  g.ca = (int)g.at(32);
  g.ra = g.at(33);
  g.cb = (int)g.at(kRow + 32);
  g.rb = g.at(kRow + 33);

  const float pax_t = in.pax, pay_t = in.pay, qas = in.qas, qac = in.qac;
  const float pbx_t = in.pbx, pby_t = in.pby, qbs = in.qbs, qbc = in.qbc;
  const int* cache_in = in.cache;
  const long long c7 = (long long)w * 7 * C + c;

  // B into A's frame (reference: src/manifold.c:515-525)
  g.xqs = qac * qbs - qas * qbc;
  g.xqc = qac * qbc + qas * qbs;
  const float dxp = pbx_t - pax_t, dyp = pby_t - pay_t;
  g.xpx = qac * dxp + qas * dyp;
  g.xpy = -qas * dxp + qac * dyp;
  const float xqs = g.xqs, xqc = g.xqc, xpx = g.xpx, xpy = g.xpy;
  const float ra = g.ra, rb = g.rb;
  const int ca = g.ca, cb = g.cb;
  const float radius = ra + rb;
  const bool is_circle_a = ca == 1;
  const bool is_circle_b = cb == 1;

  // ---------------- GJK (reference: src/distance.c:482-636) ----------------
  Simplex s;
  {
    const bool use = cache_in[0] > 0;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s.ia[i] = use ? cache_in[1 + i] : 0;
      s.ib[i] = use ? cache_in[4 + i] : 0;
      s.wax[i] = g.ax(vi(s.ia[i]));
      s.way[i] = g.ay(vi(s.ia[i]));
      s.wbx[i] = g.bx(vi(s.ib[i]));
      s.wby[i] = g.by(vi(s.ib[i]));
    }
    s.count = use ? cache_in[0] : 1;
    s.bary[0] = 1.0f; s.bary[1] = 0.0f; s.bary[2] = 0.0f;
  }
  // The twin runs gjk_iters trips and masks the finished lanes; once done,
  // a trip writes nothing, so the loop ends there.
  for (int it = 0; it < gjk_iters; ++it) {
    const int save_ia0 = s.ia[0], save_ia1 = s.ia[1], save_ia2 = s.ia[2];
    const int save_ib0 = s.ib[0], save_ib1 = s.ib[1], save_ib2 = s.ib[2];
    const int save_count = s.count;
    simplex_solve(s);
    if (s.count == 3) break;

    // search direction (reference: src/distance.c:227-254)
    float w0x = s.wbx[0] - s.wax[0], w0y = s.wby[0] - s.way[0];
    float w1x = s.wbx[1] - s.wax[1], w1y = s.wby[1] - s.way[1];
    float e12x = w1x - w0x, e12y = w1y - w0y;
    float sgn = e12x * (-w0y) - e12y * (-w0x);
    float d2x = (sgn > 0.0f) ? -e12y : e12y;
    float d2y = (sgn > 0.0f) ? e12x : -e12x;
    float dx = (s.count == 1) ? -w0x : d2x;
    float dy = (s.count == 1) ? -w0y : d2y;
    if (dx * dx + dy * dy < F(kEpsD * kEpsD)) break;

    int sia = support(g, false, -dx, -dy);
    int sib = support(g, true, dx, dy);
    bool dup = (sia == save_ia0 && sib == save_ib0 && 0 < save_count)
            || (sia == save_ia1 && sib == save_ib1 && 1 < save_count)
            || (sia == save_ia2 && sib == save_ib2 && 2 < save_count);
    if (dup) break;

    float nwax = g.ax(sia), nway = g.ay(sia);
    float nwbx = g.bx(sib), nwby = g.by(sib);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      bool hit = s.count == i;
      s.wax[i] = hit ? nwax : s.wax[i];
      s.way[i] = hit ? nway : s.way[i];
      s.wbx[i] = hit ? nwbx : s.wbx[i];
      s.wby[i] = hit ? nwby : s.wby[i];
      s.ia[i] = hit ? sia : s.ia[i];
      s.ib[i] = hit ? sib : s.ib[i];
    }
    s.count = s.count + 1;
  }
  simplex_solve(s);  // idempotent on a solved simplex

  float gpax = 0.0f, gpay = 0.0f, gpbx = 0.0f, gpby = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float mask = (i < s.count) ? 1.0f : 0.0f;
    gpax = gpax + (s.bary[i] * s.wax[i]) * mask;
    gpay = gpay + (s.bary[i] * s.way[i]) * mask;
    gpbx = gpbx + (s.bary[i] * s.wbx[i]) * mask;
    gpby = gpby + (s.bary[i] * s.wby[i]) * mask;
  }
  if (s.count == 3) { gpbx = gpax; gpby = gpay; }
  const float ddx = gpbx - gpax, ddy = gpby - gpay;
  const float dist = sqrtf(ddx * ddx + ddy * ddy);

  // ---------------- path selection (mirrors manifold.collide) ----------------
  const bool circle_pair = is_circle_a && is_circle_b;
  const bool circle_one = is_circle_a != is_circle_b;
  const bool poly_pair = !(circle_pair || circle_one);
  const bool use_sat = poly_pair && (dist < F(0.1 * kLinearSlop));
  const bool use_vv = poly_pair && !use_sat && (s.count == 1);
  const bool use_clip = poly_pair && !use_sat && !use_vv;

  float nlx = 0.0f, nly = 0.0f, a0x = 0.0f, a0y = 0.0f, a1x, a1y, sep0 = 0.0f, sep1;
  int pid0 = 0, pid1;

  if (use_sat) {
    // SAT fallback (manifold.c:441-493)
    int edgeA_s, edgeB_s;
    float sepA = find_max_sep(g, false, &edgeA_s);
    float sepB = find_max_sep(g, true, &edgeB_s);
    bool flip = sepB > sepA;
    int inc_a = incident_edge(g, false, g.nbx(edgeB_s), g.nby(edgeB_s));
    int inc_b = incident_edge(g, true, g.nax(edgeA_s), g.nay(edgeA_s));
    int ea = flip ? inc_a : edgeA_s;
    int eb = flip ? edgeB_s : inc_b;
    Clip k = clip_polygons(g, ea, eb, flip);
    nlx = k.nx; nly = k.ny; a0x = k.p0x; a0y = k.p0y; a1x = k.p1x; a1y = k.p1y;
    sep0 = k.s0; sep1 = k.s1; pid0 = k.id0; pid1 = k.id1;
  } else {
    // edge-vertex via the GJK features (manifold.c:580-637); its second
    // point also fills the unused rows of the circle and vertex paths
    const int a1 = s.ia[0], a2 = s.ia[1], b1 = s.ib[0], b2 = s.ib[1];
    const bool one_on_a = a1 == a2;
    float axbx = gpax - gpbx, axby = gpay - gpby;
    float dot_b1 = axbx * g.nbx(vi(b1)) + axby * g.nby(vi(b1));
    float dot_b2 = axbx * g.nbx(vi(b2)) + axby * g.nby(vi(b2));
    int edge_b_ref = (dot_b1 > dot_b2) ? b1 : b2;
    float rbx_ax = g.nbx(vi(edge_b_ref)), rby_ax = g.nby(vi(edge_b_ref));
    int ea1 = a1;
    int ea2 = (ea1 == 0) ? ca - 1 : ea1 - 1;
    float da1 = rbx_ax * g.nax(vi(ea1)) + rby_ax * g.nay(vi(ea1));
    float da2 = rbx_ax * g.nax(vi(ea2)) + rby_ax * g.nay(vi(ea2));
    int edge_a_inc = (da1 < da2) ? ea1 : ea2;

    float axax = gpbx - gpax, axay = gpby - gpay;
    float dot_a1 = axax * g.nax(vi(a1)) + axay * g.nay(vi(a1));
    float dot_a2 = axax * g.nax(vi(a2)) + axay * g.nay(vi(a2));
    int edge_a_ref = (dot_a1 > dot_a2) ? a1 : a2;
    float rax_ax = g.nax(vi(edge_a_ref)), ray_ax = g.nay(vi(edge_a_ref));
    int eb1 = b1;
    int eb2 = (eb1 == 0) ? cb - 1 : eb1 - 1;
    float db1 = rax_ax * g.nbx(vi(eb1)) + ray_ax * g.nby(vi(eb1));
    float db2 = rax_ax * g.nbx(vi(eb2)) + ray_ax * g.nby(vi(eb2));
    int edge_b_inc = (db1 < db2) ? eb1 : eb2;

    int ea = one_on_a ? edge_a_inc : edge_a_ref;
    int eb = one_on_a ? edge_b_ref : edge_b_inc;
    Clip k = clip_polygons(g, ea, eb, one_on_a);
    a1x = k.p1x; a1y = k.p1y; sep1 = k.s1; pid1 = k.id1;
    if (use_clip) {
      nlx = k.nx; nly = k.ny; a0x = k.p0x; a0y = k.p0y; sep0 = k.s0; pid0 = k.id0;
    } else if (use_vv) {
      // vertex-vertex (manifold.c:559-577)
      float nvx, nvy, l;
      normalize2(gpbx - gpax, gpby - gpay, &nvx, &nvy, &l);
      nlx = nvx; nly = nvy;
      a0x = gpbx + (0.5f * ((ra - rb) - dist)) * nvx;
      a0y = gpby + (0.5f * ((ra - rb) - dist)) * nvy;
      sep0 = dist - radius;
      pid0 = (s.ia[0] << 8) | s.ib[0];
    } else if (circle_pair) {
      // circle-circle (manifold.c:16-48)
      float pAx = g.ax(0), pAy = g.ay(0), pBx = g.bx(0), pBy = g.by(0);
      float nx, ny, d;
      normalize2(pBx - pAx, pBy - pAy, &nx, &ny, &d);
      float cAx = pAx + ra * nx, cAy = pAy + ra * ny;
      float cBx = pBx - rb * nx, cBy = pBy - rb * ny;
      nlx = nx; nly = ny;
      a0x = 0.5f * (cAx + cBx); a0y = 0.5f * (cAy + cBy);
      sep0 = d - radius;
    } else {
      // polygon-circle (manifold.c:113-222); the polygon is B when A is
      // the circle
      const bool flip_pc = is_circle_a;
      const int cp = flip_pc ? cb : ca;
      const float rp = flip_pc ? rb : ra;
      const float rc = flip_pc ? ra : rb;
      const float ccx = flip_pc ? g.ax(0) : g.bx(0);
      const float ccy = flip_pc ? g.ay(0) : g.by(0);
      float sep_pc0;
      int i1 = first_max(cp, -kBig, [&](int j) {
        return (ccx - g.vx(flip_pc, j)) * g.nx(flip_pc, j) + (ccy - g.vy(flip_pc, j)) * g.ny(flip_pc, j);
      }, &sep_pc0);
      int i2 = (i1 + 1 < cp) ? i1 + 1 : 0;
      float v1x = g.vx(flip_pc, i1), v1y = g.vy(flip_pc, i1);
      float v2x = g.vx(flip_pc, vi(i2)), v2y = g.vy(flip_pc, vi(i2));
      float u1 = (ccx - v1x) * (v2x - v1x) + (ccy - v1y) * (v2y - v1y);
      float u2 = (ccx - v2x) * (v1x - v2x) + (ccy - v2y) * (v1y - v2y);
      float nv1x, nv1y, nv2x, nv2y, l1, l2;
      normalize2(ccx - v1x, ccy - v1y, &nv1x, &nv1y, &l1);
      normalize2(ccx - v2x, ccy - v2y, &nv2x, &nv2y, &l2);
      float sep_v1 = (ccx - v1x) * nv1x + (ccy - v1y) * nv1y;
      float sep_v2 = (ccx - v2x) * nv2x + (ccy - v2y) * nv2y;
      bool case_v1 = (u1 < 0.0f) && (sep_pc0 > eps);
      bool case_v2 = (u2 < 0.0f) && (sep_pc0 > eps) && !case_v1;
      float nfx = g.nx(flip_pc, i1), nfy = g.ny(flip_pc, i1);
      float n_pcx = case_v1 ? nv1x : (case_v2 ? nv2x : nfx);
      float n_pcy = case_v1 ? nv1y : (case_v2 ? nv2y : nfy);
      float sep_pc = case_v1 ? sep_v1 : (case_v2 ? sep_v2 : sep_pc0);
      float v_nx = case_v1 ? v1x : (case_v2 ? v2x : v1x);
      float v_ny = case_v1 ? v1y : (case_v2 ? v2y : v1y);
      float proj = (ccx - v1x) * nfx + (ccy - v1y) * nfy;
      bool is_vert = case_v1 || case_v2;
      float cA_px = is_vert ? (v_nx + rp * n_pcx) : (ccx + (rp - proj) * nfx);
      float cA_py = is_vert ? (v_ny + rp * n_pcy) : (ccy + (rp - proj) * nfy);
      float cB_px = ccx - rc * n_pcx;
      float cB_py = ccy - rc * n_pcy;
      a0x = 0.5f * (cA_px + cB_px);
      a0y = 0.5f * (cA_py + cB_py);
      sep0 = is_vert ? ((cB_px - cA_px) * n_pcx + (cB_py - cA_py) * n_pcy) : (sep_pc - radius);
      nlx = flip_pc ? -n_pcx : n_pcx;
      nly = flip_pc ? -n_pcy : n_pcy;
    }
  }

  const bool two_points = use_sat || use_clip;
  const bool any_circle = circle_pair || circle_one;
  const bool cull0 = (any_circle && (sep0 > F(kSpeculative)))
                  || ((!any_circle) && (dist > radius + F(kSpeculative)));
  const int count = cull0 ? 0 : (two_points ? 2 : 1);

  // local anchor B = inv_rotate(xq, anchor A - xp) (manifold.c:552, :645)
  const float r0x = a0x - xpx, r0y = a0y - xpy;
  const float r1x = a1x - xpx, r1y = a1y - xpy;

  const long long f12 = (long long)w * 12 * C + c;
  fout[f12 + 0 * C] = qac * nlx - qas * nly;
  fout[f12 + 1 * C] = qas * nlx + qac * nly;
  fout[f12 + 2 * C] = a0x;
  fout[f12 + 3 * C] = a0y;
  fout[f12 + 4 * C] = a1x;
  fout[f12 + 5 * C] = a1y;
  fout[f12 + 6 * C] = xqc * r0x + xqs * r0y;
  fout[f12 + 7 * C] = -xqs * r0x + xqc * r0y;
  fout[f12 + 8 * C] = xqc * r1x + xqs * r1y;
  fout[f12 + 9 * C] = -xqs * r1x + xqc * r1y;
  fout[f12 + 10 * C] = sep0;
  fout[f12 + 11 * C] = sep1;
  const long long i3 = (long long)w * 3 * C + c;
  iout[i3] = pid0;
  iout[i3 + C] = pid1;
  iout[i3 + 2 * C] = count;
  cout[c7] = s.count;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    cout[c7 + (1 + i) * C] = s.ia[i];
    cout[c7 + (4 + i) * C] = s.ib[i];
  }
}

// shared memory a block: the staged rows of its TX slots
template <int TX>
constexpr int smem_bytes() { return 2 * kRow * TX * (int)sizeof(float); }

// A block: TX slots x TW worlds.
template <int TX, int TW>
__global__ void __launch_bounds__(TX * TW, kSmThreads / (TX * TW)) collide_kernel(
    const float* __restrict__ geom, const int* __restrict__ sa, const int* __restrict__ sb,
    const float* __restrict__ pa, const float* __restrict__ pb, const int* __restrict__ cache,
    float* __restrict__ fout, int* __restrict__ iout, int* __restrict__ cout,
    int W, int C, int gjk_iters) {
  extern __shared__ float sg[];  // smem_bytes<TX>()
  const int c0 = blockIdx.x * TX;
  const int c = c0 + threadIdx.x;
  const int w = blockIdx.y * TW + threadIdx.y;
  const bool live = c < C && w < W;
  // the slot's own loads go out before the staging, so their latency
  // passes while the block stages and waits
  SlotIn in;
  if (live) in = load_slot(pa, pb, cache, w, c, C);
  stage_rows<TX, TW>(sg, geom, sa, sb, C, c0, threadIdx.y * TX + threadIdx.x);
  __syncthreads();
  if (!live) return;
  collide_slot<TX>(sg + threadIdx.x, in, fout, iout, cout, w, c, C, gjk_iters);
}

template <int TX, int TW>
int launch(const float* geom, const int* sa, const int* sb, const float* pa, const float* pb, const int* cache,
           float* fout, int* iout, int* cout, int W, int C, int gjk_iters, cudaStream_t stream) {
  const dim3 grid((unsigned)((C + TX - 1) / TX), (unsigned)((W + TW - 1) / TW));
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<TX>();
  static_assert(smem <= 48 * 1024, "K2 stages at most 48 KB a block");
  collide_kernel<TX, TW><<<grid, dim3(TX, TW), smem, stream>>>(geom, sa, sb, pa, pb, cache, fout, iout, cout, W, C,
                                                            gjk_iters);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes. Launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int s2t_collide_lanes(const float* geom, const int* sa, const int* sb, const float* pa,
                                 const float* pb, const int* cache, float* fout, int* iout, int* cout,
                                 int W, int C, int gjk_iters, void* stream) {
  if ((long long)W * C == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (W >= kLaneTW)
    return launch<kLaneTX, kLaneTW>(geom, sa, sb, pa, pb, cache, fout, iout, cout, W, C, gjk_iters, st);
  return launch<kThreads, 1>(geom, sa, sb, pa, pb, cache, fout, iout, cout, W, C, gjk_iters, st);
}

// The compiled kernel that a batch of W worlds launches: out[0] registers a
// thread, out[1] shared memory bytes a block, out[2] local (spill) bytes a
// thread, out[3] resident blocks an SM, out[4] slots a block (TX), out[5]
// worlds a block (TW). Returns a cudaError_t.
extern "C" int s2t_collide_attrs(int W, int* out) {
  const bool lane = W >= kLaneTW;
  const void* fn = lane ? (const void*)collide_kernel<kLaneTX, kLaneTW> : (const void*)collide_kernel<kThreads, 1>;
  const int threads = lane ? kLaneTX * kLaneTW : kThreads;
  cudaFuncAttributes at;
  cudaError_t e = cudaFuncGetAttributes(&at, fn);
  if (e != cudaSuccess) return (int)e;
  const int smem = lane ? smem_bytes<kLaneTX>() : smem_bytes<kThreads>();
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = at.numRegs;
  out[1] = smem;
  out[2] = (int)at.localSizeBytes;
  out[3] = blocks;
  out[4] = lane ? kLaneTX : kThreads;
  out[5] = lane ? kLaneTW : 1;
  return 0;
}
