// K2: the lane-batched narrowphase on Hopper (sm_90a).
//
// Replaces the TPU kernel solver2d_tpu/ops/narrow_pallas.py:_kernel (launched
// by collide_lanes_pallas), whose math is ops/narrow_lanes.py:collide_lanes.
// One thread per (world, contact): warm-started GJK with a fixed trip count
// and a 3-vertex simplex cache in and out, SAT max separation, reference /
// incident edge clipping into a manifold of at most 2 points with feature
// ids, and the circle paths (reference: src/distance.c:91-636,
// src/manifold.c:16-650).
//
// Design. Everything lives in registers: each thread loads the two shapes'
// geometry rows (34 floats each) straight from the shared [S, 34] shape table
// by the contact's shape indices, so the shape-row gather folds into the
// loads; the table is a few hundred KB and stays in L1/L2. Poses [W, 4, C]
// and caches [W, 7, C] are read, and outputs [W, 12|3|7, C] written, with
// neighbouring threads on neighbouring contacts (coalesced). Only the
// manifold path a contact takes is computed; the plain twin computes every
// path and selects, which gives the same values.
//
// Numbers. The operation order is that of the plain twin
// (solver2d_tpu_torch/ops/narrow_lanes.py); built with -fmad=false and IEEE
// division and square root, the kernel rounds as the twin does on the card,
// so ties in the argmax/argmin scans break alike and the integer outputs
// (feature ids, point counts, GJK caches) agree exactly.
//
// Bound. Per (world, contact) it reads 60 bytes (two poses, the cache) and
// writes 88 (12 floats, 3 + 7 ints); at the main path's 512 worlds x 7936
// contacts that is ~0.6 GB, ~0.18 ms at 3.35 TB/s. The float work (10 GJK
// trips of support scans and simplex solves, the SAT scans, one clip) is of
// the same order at the card's 67 TFLOP/s fp32 rate; chip_smoke.py counts
// both for the run's inputs and reports the larger as the bound.

#include <cuda_runtime.h>
#include <stdint.h>

#define F(x) ((float)(x))

namespace {

constexpr double kEpsD = 1.1920929e-07;
constexpr double kLinearSlop = 0.005;
constexpr double kSpeculative = 4.0 * kLinearSlop;

__device__ __forceinline__ float pick8(const float (&v)[8], int idx) {
  float out = v[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) out = (idx == j) ? v[j] : out;
  return out;
}

template <typename T>
__device__ __forceinline__ T pick3(T a0, T a1, T a2, int idx) {
  return idx == 2 ? a2 : (idx == 1 ? a1 : a0);
}

// running (first max) over the 8 rows, rows >= count masked to -BIG
__device__ __forceinline__ int argmax8(const float (&s)[8], int count, float* val) {
  const float big = F(1e30);
  int bi = 0;
  float bs = (0 < count) ? s[0] : -big;
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    float sj = (j < count) ? s[j] : -big;
    bool t = sj > bs;
    bi = t ? j : bi;
    bs = t ? sj : bs;
  }
  *val = bs;
  return bi;
}

// running (first min) over the rows < count
__device__ __forceinline__ int argmin8(const float (&s)[8], int count) {
  const float big = F(1e30);
  int bi = 0;
  float bs = -((0 < count) ? s[0] : big);
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    float sj = -((j < count) ? s[j] : big);
    bool t = sj > bs;
    bi = t ? j : bi;
    bs = t ? sj : bs;
  }
  return bi;
}

__device__ __forceinline__ int support(const float (&vx)[8], const float (&vy)[8], int count,
                                       float dx, float dy) {
  const float ninf = -__int_as_float(0x7f800000);
  int bi = 0;
  float bs = (0 < count) ? (vx[0] * dx + vy[0] * dy) : ninf;
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    float sj = (j < count) ? (vx[j] * dx + vy[j] * dy) : ninf;
    bool t = sj > bs;
    bi = t ? j : bi;
    bs = t ? sj : bs;
  }
  return bi;
}

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
  const int p0[7] = {0, 0, 0, 1, 2, 2, 0};
  const int p1[7] = {1, 1, 2, 1, 1, 1, 1};
  const int p2[7] = {2, 2, 1, 2, 2, 0, 2};
  const int cn[7] = {1, 2, 2, 1, 1, 2, 3};
  perm[0] = p0[c]; perm[1] = p1[c]; perm[2] = p2[c];
  *newc = cn[c];
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

// reference: src/manifold.c:402-438
__device__ __forceinline__ float find_max_sep(const float (&v1x)[8], const float (&v1y)[8],
                                              const float (&n1x)[8], const float (&n1y)[8], int c1,
                                              const float (&v2x)[8], const float (&v2y)[8], int c2,
                                              int* edge) {
  const float big = F(1e30);
  float best[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float rowdot = n1x[i] * v1x[i] + n1y[i] * v1y[i];
    float b = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float sj = (j < c2) ? ((n1x[i] * v2x[j] + n1y[i] * v2y[j]) - rowdot) : big;
      b = (j == 0) ? sj : fminf(b, sj);
    }
    best[i] = b;
  }
  float val;
  *edge = argmax8(best, c1, &val);
  return val;
}

__device__ __forceinline__ int incident_edge(float sdx, float sdy, const float (&nx)[8],
                                             const float (&ny)[8], int count) {
  float dots[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) dots[i] = nx[i] * sdx + ny[i] * sdy;
  return argmin8(dots, count);
}

struct Clip {
  float nx, ny, p0x, p0y, p1x, p1y, s0, s1;
  int id0, id1;
};

// reference: src/manifold.c:248-399
__device__ __forceinline__ Clip clip_polygons(
    const float (&vax)[8], const float (&vay)[8], const float (&nax)[8], const float (&nay)[8], int ca, float ra,
    const float (&vbx)[8], const float (&vby)[8], const float (&nbx)[8], const float (&nby)[8], int cb, float rb,
    int edge_a, int edge_b, bool flip) {
  const float eps = F(kEpsD);
  int i11 = flip ? edge_b : edge_a;
  int cnt1 = flip ? cb : ca;
  int i12 = (i11 + 1 < cnt1) ? i11 + 1 : 0;
  int i21 = flip ? edge_a : edge_b;
  int cnt2 = flip ? ca : cb;
  int i22 = (i21 + 1 < cnt2) ? i21 + 1 : 0;

  float nx = flip ? pick8(nbx, i11) : pick8(nax, i11);
  float ny = flip ? pick8(nby, i11) : pick8(nay, i11);
  float v11x = flip ? pick8(vbx, i11) : pick8(vax, i11);
  float v11y = flip ? pick8(vby, i11) : pick8(vay, i11);
  float v12x = flip ? pick8(vbx, i12) : pick8(vax, i12);
  float v12y = flip ? pick8(vby, i12) : pick8(vay, i12);
  float v21x = flip ? pick8(vax, i21) : pick8(vbx, i21);
  float v21y = flip ? pick8(vay, i21) : pick8(vby, i21);
  float v22x = flip ? pick8(vax, i22) : pick8(vbx, i22);
  float v22y = flip ? pick8(vay, i22) : pick8(vby, i22);
  float r1 = flip ? rb : ra;
  float r2 = flip ? ra : rb;

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

__global__ void __launch_bounds__(128) collide_kernel(
    const float* __restrict__ geom, const int* __restrict__ sa, const int* __restrict__ sb,
    const float* __restrict__ pa, const float* __restrict__ pb, const int* __restrict__ cache,
    float* __restrict__ fout, int* __restrict__ iout, int* __restrict__ cout,
    int W, int C, int gjk_iters) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)W * C) return;
  const int w = (int)(t / C);
  const int c = (int)(t - (long long)w * C);
  const float eps = F(kEpsD);

  // shape geometry rows: vx(8) vy(8) nx(8) ny(8) count radius
  float vax[8], vay[8], nax[8], nay[8], vbx[8], vby[8], nbx[8], nby[8];
  const float* ga = geom + (long long)__ldg(sa + c) * 34;
  const float* gb = geom + (long long)__ldg(sb + c) * 34;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    vax[j] = __ldg(ga + j); vay[j] = __ldg(ga + 8 + j);
    nax[j] = __ldg(ga + 16 + j); nay[j] = __ldg(ga + 24 + j);
    vbx[j] = __ldg(gb + j); vby[j] = __ldg(gb + 8 + j);
    nbx[j] = __ldg(gb + 16 + j); nby[j] = __ldg(gb + 24 + j);
  }
  const int ca = (int)__ldg(ga + 32);
  const float ra = __ldg(ga + 33);
  const int cb = (int)__ldg(gb + 32);
  const float rb = __ldg(gb + 33);

  const long long p4 = (long long)w * 4 * C + c;
  const float pax_t = pa[p4], pay_t = pa[p4 + C], qas = pa[p4 + 2 * C], qac = pa[p4 + 3 * C];
  const float pbx_t = pb[p4], pby_t = pb[p4 + C], qbs = pb[p4 + 2 * C], qbc = pb[p4 + 3 * C];
  const long long c7 = (long long)w * 7 * C + c;
  int cache_in[7];
#pragma unroll
  for (int r = 0; r < 7; ++r) cache_in[r] = cache[c7 + r * C];

  // B into A's frame (reference: src/manifold.c:515-525)
  const float xqs = qac * qbs - qas * qbc;
  const float xqc = qac * qbc + qas * qbs;
  const float dxp = pbx_t - pax_t, dyp = pby_t - pay_t;
  const float xpx = qac * dxp + qas * dyp;
  const float xpy = -qas * dxp + qac * dyp;
  float vblx[8], vbly[8], nblx[8], nbly[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    vblx[j] = xpx + (xqc * vbx[j] - xqs * vby[j]);
    vbly[j] = xpy + (xqs * vbx[j] + xqc * vby[j]);
    nblx[j] = xqc * nbx[j] - xqs * nby[j];
    nbly[j] = xqs * nbx[j] + xqc * nby[j];
  }
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
      s.wax[i] = pick8(vax, s.ia[i]);
      s.way[i] = pick8(vay, s.ia[i]);
      s.wbx[i] = pick8(vblx, s.ib[i]);
      s.wby[i] = pick8(vbly, s.ib[i]);
    }
    s.count = use ? cache_in[0] : 1;
    s.bary[0] = 1.0f; s.bary[1] = 0.0f; s.bary[2] = 0.0f;
  }
  bool done = false;
  for (int it = 0; it < gjk_iters; ++it) {
    const int save_ia0 = s.ia[0], save_ia1 = s.ia[1], save_ia2 = s.ia[2];
    const int save_ib0 = s.ib[0], save_ib1 = s.ib[1], save_ib2 = s.ib[2];
    const int save_count = s.count;
    if (!done) simplex_solve(s);
    done = done || (s.count == 3);

    // search direction (reference: src/distance.c:227-254)
    float w0x = s.wbx[0] - s.wax[0], w0y = s.wby[0] - s.way[0];
    float w1x = s.wbx[1] - s.wax[1], w1y = s.wby[1] - s.way[1];
    float e12x = w1x - w0x, e12y = w1y - w0y;
    float sgn = e12x * (-w0y) - e12y * (-w0x);
    float d2x = (sgn > 0.0f) ? -e12y : e12y;
    float d2y = (sgn > 0.0f) ? e12x : -e12x;
    float dx = (s.count == 1) ? -w0x : d2x;
    float dy = (s.count == 1) ? -w0y : d2y;
    done = done || (dx * dx + dy * dy < F(kEpsD * kEpsD));

    int sia = support(vax, vay, ca, -dx, -dy);
    int sib = support(vblx, vbly, cb, dx, dy);
    bool dup = (sia == save_ia0 && sib == save_ib0 && 0 < save_count)
            || (sia == save_ia1 && sib == save_ib1 && 1 < save_count)
            || (sia == save_ia2 && sib == save_ib2 && 2 < save_count);
    done = done || dup;

    if (!done) {
      float nwax = pick8(vax, sia), nway = pick8(vay, sia);
      float nwbx = pick8(vblx, sib), nwby = pick8(vbly, sib);
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
    float sepA = find_max_sep(vax, vay, nax, nay, ca, vblx, vbly, cb, &edgeA_s);
    float sepB = find_max_sep(vblx, vbly, nblx, nbly, cb, vax, vay, ca, &edgeB_s);
    bool flip = sepB > sepA;
    int inc_a = incident_edge(pick8(nblx, edgeB_s), pick8(nbly, edgeB_s), nax, nay, ca);
    int inc_b = incident_edge(pick8(nax, edgeA_s), pick8(nay, edgeA_s), nblx, nbly, cb);
    int ea = flip ? inc_a : edgeA_s;
    int eb = flip ? edgeB_s : inc_b;
    Clip k = clip_polygons(vax, vay, nax, nay, ca, ra, vblx, vbly, nblx, nbly, cb, rb, ea, eb, flip);
    nlx = k.nx; nly = k.ny; a0x = k.p0x; a0y = k.p0y; a1x = k.p1x; a1y = k.p1y;
    sep0 = k.s0; sep1 = k.s1; pid0 = k.id0; pid1 = k.id1;
  } else {
    // edge-vertex via the GJK features (manifold.c:580-637); its second
    // point also fills the unused rows of the circle and vertex paths
    const int a1 = s.ia[0], a2 = s.ia[1], b1 = s.ib[0], b2 = s.ib[1];
    const bool one_on_a = a1 == a2;
    float axbx = gpax - gpbx, axby = gpay - gpby;
    float dot_b1 = axbx * pick8(nblx, b1) + axby * pick8(nbly, b1);
    float dot_b2 = axbx * pick8(nblx, b2) + axby * pick8(nbly, b2);
    int edge_b_ref = (dot_b1 > dot_b2) ? b1 : b2;
    float rbx_ax = pick8(nblx, edge_b_ref), rby_ax = pick8(nbly, edge_b_ref);
    int ea1 = a1;
    int ea2 = (ea1 == 0) ? ca - 1 : ea1 - 1;
    float da1 = rbx_ax * pick8(nax, ea1) + rby_ax * pick8(nay, ea1);
    float da2 = rbx_ax * pick8(nax, ea2) + rby_ax * pick8(nay, ea2);
    int edge_a_inc = (da1 < da2) ? ea1 : ea2;

    float axax = gpbx - gpax, axay = gpby - gpay;
    float dot_a1 = axax * pick8(nax, a1) + axay * pick8(nay, a1);
    float dot_a2 = axax * pick8(nax, a2) + axay * pick8(nay, a2);
    int edge_a_ref = (dot_a1 > dot_a2) ? a1 : a2;
    float rax_ax = pick8(nax, edge_a_ref), ray_ax = pick8(nay, edge_a_ref);
    int eb1 = b1;
    int eb2 = (eb1 == 0) ? cb - 1 : eb1 - 1;
    float db1 = rax_ax * pick8(nblx, eb1) + ray_ax * pick8(nbly, eb1);
    float db2 = rax_ax * pick8(nblx, eb2) + ray_ax * pick8(nbly, eb2);
    int edge_b_inc = (db1 < db2) ? eb1 : eb2;

    int ea = one_on_a ? edge_a_inc : edge_a_ref;
    int eb = one_on_a ? edge_b_ref : edge_b_inc;
    Clip k = clip_polygons(vax, vay, nax, nay, ca, ra, vblx, vbly, nblx, nbly, cb, rb, ea, eb, one_on_a);
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
      float pAx = vax[0], pAy = vay[0], pBx = vblx[0], pBy = vbly[0];
      float nx, ny, d;
      normalize2(pBx - pAx, pBy - pAy, &nx, &ny, &d);
      float cAx = pAx + ra * nx, cAy = pAy + ra * ny;
      float cBx = pBx - rb * nx, cBy = pBy - rb * ny;
      nlx = nx; nly = ny;
      a0x = 0.5f * (cAx + cBx); a0y = 0.5f * (cAy + cBy);
      sep0 = d - radius;
    } else {
      // polygon-circle (manifold.c:113-222)
      const bool flip_pc = is_circle_a;
      float vpx[8], vpy[8], npx[8], npy[8], seps[8];
      const int cp = flip_pc ? cb : ca;
      const float rp = flip_pc ? rb : ra;
      const float rc = flip_pc ? ra : rb;
      const float ccx = flip_pc ? vax[0] : vblx[0];
      const float ccy = flip_pc ? vay[0] : vbly[0];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        vpx[j] = flip_pc ? vblx[j] : vax[j];
        vpy[j] = flip_pc ? vbly[j] : vay[j];
        npx[j] = flip_pc ? nblx[j] : nax[j];
        npy[j] = flip_pc ? nbly[j] : nay[j];
        seps[j] = (ccx - vpx[j]) * npx[j] + (ccy - vpy[j]) * npy[j];
      }
      float sep_pc0;
      int i1 = argmax8(seps, cp, &sep_pc0);
      int i2 = (i1 + 1 < cp) ? i1 + 1 : 0;
      float v1x = pick8(vpx, i1), v1y = pick8(vpy, i1);
      float v2x = pick8(vpx, i2), v2y = pick8(vpy, i2);
      float u1 = (ccx - v1x) * (v2x - v1x) + (ccy - v1y) * (v2y - v1y);
      float u2 = (ccx - v2x) * (v1x - v2x) + (ccy - v2y) * (v1y - v2y);
      float nv1x, nv1y, nv2x, nv2y, l1, l2;
      normalize2(ccx - v1x, ccy - v1y, &nv1x, &nv1y, &l1);
      normalize2(ccx - v2x, ccy - v2y, &nv2x, &nv2y, &l2);
      float sep_v1 = (ccx - v1x) * nv1x + (ccy - v1y) * nv1y;
      float sep_v2 = (ccx - v2x) * nv2x + (ccy - v2y) * nv2y;
      bool case_v1 = (u1 < 0.0f) && (sep_pc0 > eps);
      bool case_v2 = (u2 < 0.0f) && (sep_pc0 > eps) && !case_v1;
      float nfx = pick8(npx, i1), nfy = pick8(npy, i1);
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

}  // namespace

// C interface, bound with ctypes. Launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int s2t_collide_lanes(const float* geom, const int* sa, const int* sb, const float* pa,
                                 const float* pb, const int* cache, float* fout, int* iout, int* cout,
                                 int W, int C, int gjk_iters, void* stream) {
  const long long n = (long long)W * C;
  if (n == 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  collide_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(geom, sa, sb, pa, pb, cache, fout, iout,
                                                               cout, W, C, gjk_iters);
  return (int)cudaGetLastError();
}
