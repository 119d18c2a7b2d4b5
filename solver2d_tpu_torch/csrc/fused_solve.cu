// K1: the fused soft solve of the per-world step on Hopper (sm_90a).
//
// Replaces the TPU kernel solver2d_tpu/solvers/pallas_solver.py:_kernel
// (launched by fused_solve, pallas_solver.py:428) in the three scripts the
// JAX package runs it with, each a template instantiation (Script* below):
// - TGS_Soft (loop="substep", mode=TGS_SOFT, fixed_warm=False; reference:
//   src/solve_tgs_soft.c:138-280). Per substep it integrates velocities,
//   warm starts the joints and then the contacts, runs one colored pass over
//   the soft revolute and mouse joints and one over the contacts, integrates
//   positions, and relaxes with one more pass of each (no bias, mouse joints
//   left alone).
// - SoftStep (loop="substep", mode=SOFT_STEP, fixed_warm=True;
//   src/solve_soft_step.c:182-311): the same loop; the contacts warm start
//   and solve at the prepare-time anchors r_a0, r_b0, and the soft bias is
//   clamped at half TGS_Soft's.
// - PGS_Soft (loop="pgs", mode=PGS_SOFT; src/solve_pgs_soft.c:127-242): one
//   velocity integrate, the warm start of contacts and then joints,
//   `substeps` biased passes (joints, then contacts), one position
//   integrate, then `relax` relax passes. The contacts solve at r_a0, r_b0
//   with the prepared separation.
//
// Design. One block of 256 threads a world. The world's packed body state
// [B, 8] and its per-body constants [B, 8] live in shared memory for the
// whole solve (64 B a body: 13.5 KB at 211 bodies; the freeze gate keeps it
// under the 227 KB a block may have). At the start the block sorts its
// constraints into per-color lists: it counts each color's active winners
// (and, in a last group, the active contacts and planned joints that are
// warm started but not solved) with shared-memory atomics, takes a prefix
// sum, and places each constraint in its group. The order inside a group is
// free: a color's constraints touch disjoint dynamic bodies (the coloring's
// one-writer rule), so any order gives the same bits. Then it stages, in
// list order, the rows it will read on every pass into the rest of the
// shared memory, `stage_bytes` of it (the wrapper gives what is left after
// the bodies, or, where the worlds outnumber the SMs, what lets 2 blocks
// share an SM, so that one block's phases fill the other's barrier
// waits): the float columns the script reads (27 of a contact's 37
// for TGS_Soft, 35 for the others; a joint's 23; an odd stride, so a warp
// reading one column of neighbouring rows hits distinct banks), their
// impulses and body indices and flags, then the warm start's delta tables
// and plans. What does not fit is read from global memory through the same
// code with a row pointer: the lists themselves, a tail of rows, the
// deltas, the plans. A color phase gives list entry i to thread i, gathers
// the two body rows from shared memory, solves in registers and writes back
// only the endpoints it owns; a block barrier separates the phases. A color
// whose list is empty is skipped with its barrier (the counts are the
// block's, so every thread skips alike), and so are the warm starts of a
// world without active contacts or live joints. Impulses of staged rows go
// back to global memory once, at the end. The warm start writes each
// constraint's two deltas to a table by slot, then one thread a body adds
// its deltas in the order the wrapper's plan gives (contacts: the JAX
// scatter's [body_a; body_b] order; joints: color order), never with
// atomics. The one-hot incidence products of the TPU kernel become these
// indexed loads and stores.
//
// A mouse joint never writes its body A, but reads A's velocity in its
// pivot velocity, as the JAX package's joints.solve_joint_core does. That
// read is race-free for a dynamic A too: the joint coloring gives each
// colored joint its (body, color) cell at both dynamic endpoints, so no
// other joint of its color writes A in that phase.
//
// Numbers. The operation order is that of the plain twin
// (solver2d_tpu_torch/solvers/fused_solve.py:fused_solve_plain, which calls
// contact_kernels.solve_contact_core and joints.solve_joint_core); built
// with -fmad=false and IEEE division and square root, without fast math or
// flush-to-zero, the kernel rounds as the twin does, and its atan2 is the
// package's polynomial. Constants are double literals cast to float, as
// PyTorch casts a Python scalar.
//
// Bound. Per world the function must read the int row of every constraint
// slot (4 words), the float columns its script's solve reads of each active
// contact and its 4 impulses, the 23 columns and 5 impulses of each live
// joint, the body rows (16 words), and write the bodies and those impulses.
// TGS_Soft reads 27 contact columns (not r_a0, r_b0, separation: columns
// 15-24); SoftStep 35 (not separation); PGS_Soft 35 (not the adjusted
// separation, 25-26), 27 without the warm start, which alone rotates the
// local anchors. At 64 worlds x 896 slots (590 active) x 211 bodies that is
// 7.5 MB (TGS_Soft) to 8.7 MB, a few microseconds at 3.35 TB/s. Its
// floating-point work is a few hundred operations per constraint and pass.
// What bounds it is latency: barrier-separated phases, each a dependent
// chain of a few hundred operations on one constraint per thread, one phase
// per non-empty color and pass, 64 blocks on 132 SMs. The kernel counts its
// barriers (`phases`); chip_smoke.py reports them, the time a phase, and
// the bound as the larger of the bytes and the operations of this run's
// inputs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr double kPi = 3.14159265359;        // config.PI
constexpr double kMathPi = 3.141592653589793;  // math.pi
constexpr int kNF = 37;                      // contact fields
constexpr int kNJF = 23;                     // joint fields
constexpr int kThreads = 256;
constexpr int kMaxColors = 30;               // the wrapper's limit
constexpr int kGroups = kMaxColors + 2;      // per-color lists, the warm-only group, the total
// per world, the global ints behind what is not staged: 4 group tables,
// then the contact and joint lists (s2t_fused_solve's iscratch)
constexpr int kScratchHead = 4 * kGroups;

// contact flag bits (fused_solve.py C_*)
constexpr int C_PMASK0 = 1, C_ACTIVE = 4, C_WRITE_A = 8, C_WRITE_B = 16, C_WINNER = 32;
// joint flag bits (fused_solve.py J_*)
constexpr int J_MOUSE = 1, J_ACTIVE = 2, J_LIMIT = 4, J_MOTOR = 8, J_WRITE_A = 16, J_WRITE_B = 32,
              J_WINNER = 64;

#define F(x) ((float)(x))

// The scripts (solvers/scripts.py:SCRIPTS; a script's id is its index there).
// current_anchors: the contact solve rotates the local anchors to the
// current rotation (else r_a0, r_b0); sep_from_delta: the separation follows
// the bodies' deltas (else the prepared one); clamp: the soft bias's floor
// in units of -MAX_BAUMGARTE_VELOCITY (4); fixed_warm: the contact warm
// start at r_a0, r_b0; pgs: the PGS loop (else the substep loop). The
// contact columns a script reads are staged, `ncol` of them; col(k) is
// column k's place in a staged row.
struct ScriptTgsSoft {
  static constexpr bool current_anchors = true, sep_from_delta = true, fixed_warm = false, pgs = false;
  static constexpr double clamp = 1.0;
  static constexpr int ncol = 27;  // not r_a0, r_b0, separation (15-24)
  __device__ static constexpr bool reads(int k) { return k < 15 || k >= 25; }
  __device__ static constexpr int col(int k) { return k < 15 ? k : k - 10; }
};
struct ScriptSoftStep {
  static constexpr bool current_anchors = false, sep_from_delta = true, fixed_warm = true, pgs = false;
  static constexpr double clamp = 0.5;
  static constexpr int ncol = 35;  // not the separation (23-24)
  __device__ static constexpr bool reads(int k) { return k < 23 || k >= 25; }
  __device__ static constexpr int col(int k) { return k < 23 ? k : k - 2; }
};
struct ScriptPgsSoft {
  static constexpr bool current_anchors = false, sep_from_delta = false, fixed_warm = false, pgs = true;
  static constexpr double clamp = 0.5;
  static constexpr int ncol = 35;  // not the adjusted separation (25-26)
  __device__ static constexpr bool reads(int k) { return k < 25 || k >= 27; }
  __device__ static constexpr int col(int k) { return k < 25 ? k : k - 2; }
};

// ops/math2d.py:atan2, operation for operation
__device__ __forceinline__ float atan2_pkg(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
  const float a = lo / (hi > 0.0f ? hi : 1.0f);
  const bool big = a > F(0.4142135623730950);
  const float z = big ? (a - 1.0f) / (a + 1.0f) : a;
  const float z2 = z * z;
  const float p =
      ((((F(8.05374449538e-2) * z2 - F(1.38776856032e-1)) * z2 + F(1.99777106478e-1)) * z2 - F(3.33329491874e-1)) *
       z2) * z + z;
  float t = big ? F(0.25 * kMathPi) + p : p;
  t = (ay > ax) ? F(0.5 * kMathPi) - t : t;
  t = (x < 0.0f) ? F(kMathPi) - t : t;
  return (y < 0.0f) ? -t : t;
}

// m.rotate(q, v): q = (sin, cos)
__device__ __forceinline__ void rotate(float qs, float qc, float vx, float vy, float* ox, float* oy) {
  *ox = qc * vx - qs * vy;
  *oy = qs * vx + qc * vy;
}

__device__ __forceinline__ float cross(float ax, float ay, float bx, float by) { return ax * by - ay * bx; }

struct Params {
  const float* body_const;  // [W, B, 8]
  const float* bs0;         // [W, B, 8]
  const float* cfields;     // [W, C, 37]
  const int* cint;          // [W, C, 4]
  const float* n0;          // [W, C, 2]
  const float* t0;
  const float* jfields;     // [W, J, 23]
  const int* jint;          // [W, J, 4]
  const float* jimp0;       // [W, J, 5]
  const int* c_off;         // [W, B+1]
  const int* c_ent;         // [W, 2C]
  const int* j_off;         // [W, B+1]
  const int* j_ent;         // [W, 2J]
  const float* scal;        // [2] h, inv_h
  float* bs_out;            // [W, B, 8]
  float* n_out;             // [W, C, 2]
  float* t_out;
  float* jimp_out;          // [W, J, 5]
  float* cdelta;            // [W, 2C, 3] scratch
  float* jdelta;            // [W, 2J, 3] scratch
  int* iscratch;            // [W, kScratchHead + C + J] scratch
  int* phases;              // [W] barriers the block passed, or null
  int W, B, C, J, K, KJ, substeps, relax, warm_start, stage_bytes;
};

// Shared memory past the bodies, handed out front to back in 16-byte
// units; what does not fit stays in global memory.
struct Carve {
  char* p;
  int left;
  __device__ void* take(int bytes) {
    bytes = (bytes + 15) & ~15;
    if (bytes > left) return nullptr;
    void* r = p;
    p += bytes;
    left -= bytes;
    return r;
  }
  // how many items of `bytes` bytes fit in `parts` 16-byte aligned arrays
  __device__ int fit(int bytes, int parts) const {
    const int room = left - 16 * parts;
    return room > 0 ? room / bytes : 0;
  }
};

// One world's solve state; every thread holds the same copy.
struct World {
  float* sbs;  // [B, 8] body state (shared)
  float* sbc;  // [B, 8] body constants (shared)
  // group tables: start offsets (group g at [g], the total at [K + 1]) and
  // cursors, for contacts (groups 0..K-1 the colors, K the warm-only) and
  // joints (0..KJ-1, KJ)
  int *cofs, *ccur, *jofs, *jcur;
  int *clist, *jlist;  // slot of each list entry
  // staged rows of the first ncap_c contacts and ncap_j joints of the lists:
  // columns (stride ncol / 23), impulses and ints (SoA, stride ncap)
  int ncap_c, ncap_j;
  float *scf, *scimp, *sjf, *sjimp;
  int *sci, *sji;
  float *cdelta, *jdelta;
  const int *c_off, *c_ent, *j_off, *j_ent;
  int w, nc, nj;  // the world; its listed contacts and joints
  float h, inv_h;
  int phases;
};

__device__ __forceinline__ void barrier(World& a) {
  __syncthreads();
  ++a.phases;
}

// A contact's row: staged (columns at col(k)) or in global memory.
template <class S>
struct CRow {
  const float* f;
  bool staged;
  float *n, *t;  // impulses: point q at n[q * is]
  int is;
  int ia, ib, flags, c;
  __device__ __forceinline__ float operator[](int k) const { return f[staged ? S::col(k) : k]; }
};

template <class S>
__device__ __forceinline__ CRow<S> contact_row(const Params& p, const World& a, int pos) {
  CRow<S> r;
  r.c = a.clist[pos];
  if (pos < a.ncap_c) {
    r.f = a.scf + pos * S::ncol;
    r.staged = true;
    r.n = a.scimp + pos;
    r.t = a.scimp + 2 * a.ncap_c + pos;
    r.is = a.ncap_c;
    r.ia = a.sci[pos];
    r.ib = a.sci[a.ncap_c + pos];
    r.flags = a.sci[2 * a.ncap_c + pos];
  } else {
    const long long row = (long long)a.w * p.C + r.c;
    r.f = p.cfields + row * kNF;
    r.staged = false;
    r.n = p.n_out + row * 2;
    r.t = p.t_out + row * 2;
    r.is = 1;
    const int* ci = p.cint + row * 4;
    r.ia = ci[0];
    r.ib = ci[1];
    r.flags = ci[3];
  }
  return r;
}

// A joint's row: staged or in global memory (23 columns either way).
struct JRow {
  const float* f;
  float* imp;  // impulse q at imp[q * is]
  int is;
  int ja, jb, flags, j;
};

__device__ __forceinline__ JRow joint_row(const Params& p, const World& a, int pos) {
  JRow r;
  r.j = a.jlist[pos];
  if (pos < a.ncap_j) {
    r.f = a.sjf + pos * kNJF;
    r.imp = a.sjimp + pos;
    r.is = a.ncap_j;
    r.ja = a.sji[pos];
    r.jb = a.sji[a.ncap_j + pos];
    r.flags = a.sji[2 * a.ncap_j + pos];
  } else {
    const long long row = (long long)a.w * p.J + r.j;
    r.f = p.jfields + row * kNJF;
    r.imp = p.jimp_out + row * 5;
    r.is = 1;
    const int* ji = p.jint + row * 4;
    r.ja = ji[0];
    r.jb = ji[1];
    r.flags = ji[3];
  }
  return r;
}

// The anchors of a contact's point j: rotated to the current rotation, or
// the prepare-time r_a0, r_b0 (columns 15-22).
template <bool kCurrent, class S>
__device__ __forceinline__ void contact_anchors(const CRow<S>& f, int j, float qAs, float qAc, float qBs, float qBc,
                                                float* rAx, float* rAy, float* rBx, float* rBy) {
  if (kCurrent) {
    rotate(qAs, qAc, f[7 + 2 * j], f[8 + 2 * j], rAx, rAy);
    rotate(qBs, qBc, f[11 + 2 * j], f[12 + 2 * j], rBx, rBy);
  } else {
    *rAx = f[15 + 2 * j];
    *rAy = f[16 + 2 * j];
    *rBx = f[19 + 2 * j];
    *rBy = f[20 + 2 * j];
  }
}

// One contact's soft solve (contact_kernels.solve_contact_core in the
// script's mode), then its writes.
template <class S, bool kBias>
__device__ void solve_contact(const World& a, const CRow<S>& f) {
  const int flags = f.flags;
  float* A = a.sbs + f.ia * 8;
  float* Bo = a.sbs + f.ib * 8;
  float vAx = A[0], vAy = A[1], wA = A[2];
  const float dcAx = A[3], dcAy = A[4], qAs = A[5], qAc = A[6];
  float vBx = Bo[0], vBy = Bo[1], wB = Bo[2];
  const float dcBx = Bo[3], dcBy = Bo[4], qBs = Bo[5], qBc = Bo[6];
  const float mA = f[0], iA = f[1], mB = f[2], iB = f[3];
  const float nx = f[4], ny = f[5], fr = f[6];
  const float tx = ny, ty = -nx;
  const float inv_h = a.inv_h;
  float ncol[2] = {f.n[0], f.n[f.is]};
  float tcol[2] = {f.t[0], f.t[f.is]};

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float rAx, rAy, rBx, rBy;
    contact_anchors<S::current_anchors>(f, j, qAs, qAc, qBs, qBc, &rAx, &rAy, &rBx, &rBy);
    float s;
    if (S::sep_from_delta) {
      float rsAx, rsAy, rsBx, rsBy;
      contact_anchors<true>(f, j, qAs, qAc, qBs, qBc, &rsAx, &rsAy, &rsBx, &rsBy);
      const float dsx = (dcBx - dcAx) + (rsBx - rsAx);
      const float dsy = (dcBy - dcAy) + (rsBy - rsAy);
      s = (dsx * nx + dsy * ny) + f[25 + j];
    } else {
      s = f[23 + j];
    }
    const bool spec = s > 0.0f;
    float bias, mass_scale, imp_scale;
    if (kBias) {
      const float bias_pen = fmaxf(f[31 + j] * s, F(-S::clamp * 4.0));
      bias = spec ? s * inv_h : bias_pen;
      mass_scale = spec ? 1.0f : f[33 + j];
      imp_scale = spec ? 0.0f : f[35 + j];
    } else {
      bias = spec ? s * inv_h : 0.0f;
      mass_scale = 1.0f;
      imp_scale = 0.0f;
    }
    const float vrx = (vBx + (-wB) * rBy) - (vAx + (-wA) * rAy);
    const float vry = (vBy + wB * rBx) - (vAy + wA * rAx);
    const float vn = vrx * nx + vry * ny;
    const float old = ncol[j];
    const float impulse = (-f[27 + j]) * mass_scale * (vn + bias) - imp_scale * old;
    const float nt = (flags & (C_PMASK0 << j)) ? fmaxf(old + impulse, 0.0f) : old;
    ncol[j] = nt;
    const float d = nt - old;
    const float Px = d * nx, Py = d * ny;
    vAx = vAx - mA * Px;
    vAy = vAy - mA * Py;
    wA = wA - iA * cross(rAx, rAy, Px, Py);
    vBx = vBx + mB * Px;
    vBy = vBy + mB * Py;
    wB = wB + iB * cross(rBx, rBy, Px, Py);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float rAx, rAy, rBx, rBy;
    contact_anchors<S::current_anchors>(f, j, qAs, qAc, qBs, qBc, &rAx, &rAy, &rBx, &rBy);
    const float vrx = (vBx + (-wB) * rBy) - (vAx + (-wA) * rAy);
    const float vry = (vBy + wB * rBx) - (vAy + wA * rAx);
    const float vt = vrx * tx + vry * ty;
    const float lam = (-f[29 + j]) * vt;
    const float max_f = fr * ncol[j];
    const float old = tcol[j];
    const float nt = (flags & (C_PMASK0 << j)) ? fminf(fmaxf(old + lam, -max_f), max_f) : old;
    tcol[j] = nt;
    const float d = nt - old;
    const float Px = d * tx, Py = d * ty;
    vAx = vAx - mA * Px;
    vAy = vAy - mA * Py;
    wA = wA - iA * cross(rAx, rAy, Px, Py);
    vBx = vBx + mB * Px;
    vBy = vBy + mB * Py;
    wB = wB + iB * cross(rBx, rBy, Px, Py);
  }
  if (flags & C_WRITE_A) {
    A[0] = vAx;
    A[1] = vAy;
    A[2] = wA;
  }
  if (flags & C_WRITE_B) {
    Bo[0] = vBx;
    Bo[1] = vBy;
    Bo[2] = wB;
  }
  f.n[0] = ncol[0];
  f.n[f.is] = ncol[1];
  f.t[0] = tcol[0];
  f.t[f.is] = tcol[1];
}

template <bool kBias>
__device__ __forceinline__ float limit_impulse(float C, float cdot, float old, float scale_imp, float am, float bc,
                                               float mc, float ic, float inv_h) {
  const bool spec = C > 0.0f;
  float bias, mass_scale, imp_scale;
  if (kBias) {
    bias = spec ? C * inv_h : bc * C;
    mass_scale = spec ? 1.0f : mc;
    imp_scale = spec ? 0.0f : ic;
  } else {
    bias = spec ? C * inv_h : 0.0f;
    mass_scale = 1.0f;
    imp_scale = 0.0f;
  }
  const float impulse = (-am) * mass_scale * (cdot + bias) - imp_scale * scale_imp;
  return fmaxf(old + impulse, 0.0f);
}

// One joint's soft solve (joints.solve_joint_core), then its writes. The
// caller passes only joints in scope (active; not mouse in a relax pass).
template <bool kBias, bool kMouse>
__device__ void solve_joint(const World& a, const JRow& r) {
  const float* f = r.f;
  const int flags = r.flags;
  const float h = a.h, inv_h = a.inv_h;
  const bool mouse = flags & J_MOUSE;
  float* A = a.sbs + r.ja * 8;
  float* Bo = a.sbs + r.jb * 8;
  float vAx = A[0], vAy = A[1], wA = A[2];
  const float dcAx = A[3], dcAy = A[4], qAs = A[5], qAc = A[6];
  float vBx = Bo[0], vBy = Bo[1], wB = Bo[2];
  const float dcBx = Bo[3], dcBy = Bo[4], qBs = Bo[5], qBc = Bo[6];
  const float mA = f[0], iA = f[1], mB = f[2], iB = f[3];
  const float am = f[10], bc = f[14], mc = f[15], ic = f[16];
  float* imp = r.imp;
  const int is = r.is;
  const float P0 = imp[0], P1 = imp[is], motor0 = imp[2 * is], lower0 = imp[3 * is], upper0 = imp[4 * is];

  // motor (joints._motor_limits)
  const bool fixed_rot = (iA + iB) == 0.0f;
  const bool rev = !mouse;
  const bool do_motor = rev && (flags & J_MOTOR) && !fixed_rot;
  float motor;
  {
    const float cdot = wB - wA - f[20];
    const float impulse = (-am) * cdot;
    const float max_imp = h * f[21];
    const float nm = fminf(fmaxf(motor0 + impulse, -max_imp), max_imp);
    const float d = do_motor ? nm - motor0 : 0.0f;
    motor = do_motor ? nm : motor0;
    wA = wA - iA * d;
    wB = wB + iB * d;
  }
  // angle limits; the upper side's impulse-scale term reads the lower
  // impulse (revolute_joint.c:595)
  const bool do_limit = rev && (flags & J_LIMIT) && !fixed_rot;
  const float angle = atan2_pkg(qBs * qAc - qBc * qAs, qBc * qAc + qBs * qAs) - f[17];
  float lower, upper;
  {
    const float nl = limit_impulse<kBias>(angle - f[18], wB - wA, lower0, lower0, am, bc, mc, ic, inv_h);
    const float d = do_limit ? nl - lower0 : 0.0f;
    lower = do_limit ? nl : lower0;
    wA = wA - iA * d;
    wB = wB + iB * d;
  }
  {
    const float nu = limit_impulse<kBias>(f[19] - angle, wA - wB, upper0, lower0, am, bc, mc, ic, inv_h);
    const float d = do_limit ? nu - upper0 : 0.0f;
    upper = do_limit ? nu : upper0;
    wA = wA + iA * d;
    wB = wB - iB * d;
  }
  // mouse angular damping (joints._mouse_angular_damping)
  if (kMouse) {
    const float omega = F(2.0 * kPi * 0.5);
    const float c = h * omega * (F(2.0 * 0.1) + h * omega);
    const float imp_scale = 1.0f / (1.0f + c);
    const float mass_scale = c * imp_scale;
    const float impulse = (-mass_scale) * f[22] * wB - imp_scale * motor;
    motor = mouse ? motor + impulse : motor;
    wB = wB + (mouse ? iB * impulse : 0.0f);
  }
  // point to point
  float rAx, rAy, rBx, rBy;
  rotate(qAs, qAc, f[4], f[5], &rAx, &rAy);
  rotate(qBs, qBc, f[6], f[7], &rBx, &rBy);
  const float cdx = (vBx + (-wB) * rBy) - (vAx + (-wA) * rAy);
  const float cdy = (vBy + wB * rBx) - (vAy + wA * rAx);
  float sx, sy;
  if (mouse) {
    sx = (dcBx + rBx) + f[8];
    sy = (dcBy + rBy) + f[9];
  } else {
    sx = ((dcBx - dcAx) + (rBx - rAx)) + f[8];
    sy = ((dcBy - dcAy) + (rBy - rAy)) + f[9];
  }
  float bx, by, mass_scale, imp_scale;
  if (kBias || mouse) {
    bx = bc * sx;
    by = bc * sy;
    mass_scale = mc;
    imp_scale = ic;
  } else {
    bx = 0.0f;
    by = 0.0f;
    mass_scale = 1.0f;
    imp_scale = 0.0f;
  }
  const float r0 = cdx + bx, r1 = cdy + by;
  float b0, b1;
  if (mouse) {
    b0 = f[11] * r0 + f[12] * r1;
    b1 = f[12] * r0 + f[13] * r1;
  } else {
    const float k11 = mA + mB + rAy * rAy * iA + rBy * rBy * iB;
    const float k12 = (-rAy) * rAx * iA - rBy * rBx * iB;
    const float k22 = mA + mB + rAx * rAx * iA + rBx * rBx * iB;
    const float det = k11 * k22 - k12 * k12;
    const float inv_det = det != 0.0f ? 1.0f / det : 0.0f;
    b0 = inv_det * (k22 * r0 - k12 * r1);
    b1 = inv_det * (k11 * r1 - k12 * r0);
  }
  const float i0 = (-mass_scale) * b0 - imp_scale * P0;
  const float i1 = (-mass_scale) * b1 - imp_scale * P1;
  const float mAe = mouse ? 0.0f : mA, iAe = mouse ? 0.0f : iA;
  vAx = vAx - mAe * i0;
  vAy = vAy - mAe * i1;
  wA = wA - iAe * cross(rAx, rAy, i0, i1);
  vBx = vBx + mB * i0;
  vBy = vBy + mB * i1;
  wB = wB + iB * cross(rBx, rBy, i0, i1);
  if (flags & J_WRITE_A) {
    A[0] = vAx;
    A[1] = vAy;
    A[2] = wA;
  }
  if (flags & J_WRITE_B) {
    Bo[0] = vBx;
    Bo[1] = vBy;
    Bo[2] = wB;
  }
  imp[0] = P0 + i0;
  imp[is] = P1 + i1;
  imp[2 * is] = motor;
  imp[3 * is] = lower;
  imp[4 * is] = upper;
}

// One phase per non-empty joint color: list entry i to thread i.
template <bool kBias, bool kMouse>
__device__ void joint_colors(const Params& p, World& a) {
  for (int k = 0; k < p.KJ; ++k) {
    const int beg = a.jofs[k], n = a.jofs[k + 1] - beg;
    if (n == 0) continue;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const JRow r = joint_row(p, a, beg + i);
      if (kMouse || !(r.flags & J_MOUSE)) solve_joint<kBias, kMouse>(a, r);
    }
    barrier(a);
  }
}

template <class S, bool kBias>
__device__ void contact_colors(const Params& p, World& a) {
  for (int k = 0; k < p.K; ++k) {
    const int beg = a.cofs[k], n = a.cofs[k + 1] - beg;
    if (n == 0) continue;
    for (int i = threadIdx.x; i < n; i += blockDim.x) solve_contact<S, kBias>(a, contact_row<S>(p, a, beg + i));
    barrier(a);
  }
}

// each body adds its planned deltas [3] in plan order
__device__ void apply_plan(float* sbs, const int* off, const int* ent, const float* delta, int B) {
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    float* r = sbs + b * 8;
    for (int e = off[b]; e < off[b + 1]; ++e) {
      const float* d = delta + ent[e] * 3;
      r[0] = r[0] + d[0];
      r[1] = r[1] + d[1];
      r[2] = r[2] + d[2];
    }
  }
}

__device__ void integrate_velocities(const Params& p, World& a) {
  for (int b = threadIdx.x; b < p.B; b += blockDim.x) {
    float* r = a.sbs + b * 8;
    const float* k = a.sbc + b * 8;
    if (k[0] > 0.0f) {
      const float hm = a.h * k[2];
      r[0] = (r[0] + hm * k[3]) * k[6];
      r[1] = (r[1] + hm * k[4]) * k[6];
      r[2] = (r[2] + a.h * k[5]) * k[7];
    }
  }
  barrier(a);
}

__device__ void integrate_positions(const Params& p, World& a) {
  for (int b = threadIdx.x; b < p.B; b += blockDim.x) {
    float* r = a.sbs + b * 8;
    if (a.sbc[b * 8 + 1] > 0.0f) {
      r[3] = r[3] + a.h * r[0];
      r[4] = r[4] + a.h * r[1];
      const float oh = a.h * r[2];
      const float qs = r[5] + oh * r[6];
      const float qc = r[6] - oh * r[5];
      const float mag = sqrtf(qs * qs + qc * qc);
      const float inv = mag > 0.0f ? 1.0f / fmaxf(mag, F(1e-30)) : 0.0f;
      r[5] = qs * inv;
      r[6] = qc * inv;
    }
  }
  barrier(a);
}

// joint warm start: the deltas of both endpoints of every planned joint
// (the listed ones), summed into the bodies in plan order
__device__ void joint_warm(const Params& p, World& a) {
  if (a.nj == 0) return;
  const int J = p.J;
  for (int pos = threadIdx.x; pos < a.nj; pos += blockDim.x) {
    const JRow r = joint_row(p, a, pos);
    const float* f = r.f;
    const float* A = a.sbs + r.ja * 8;
    const float* Bo = a.sbs + r.jb * 8;
    float rAx, rAy, rBx, rBy;
    rotate(A[5], A[6], f[4], f[5], &rAx, &rAy);
    rotate(Bo[5], Bo[6], f[6], f[7], &rBx, &rBy);
    const float Px = r.imp[0], Py = r.imp[r.is];
    const float axial = (r.flags & J_MOUSE) ? r.imp[2 * r.is] : r.imp[2 * r.is] + r.imp[3 * r.is] - r.imp[4 * r.is];
    float* dA = a.jdelta + r.j * 3;
    float* dB = a.jdelta + (J + r.j) * 3;
    dA[0] = (-f[0]) * Px;
    dA[1] = (-f[0]) * Py;
    dA[2] = (-f[1]) * (cross(rAx, rAy, Px, Py) + axial);
    dB[0] = f[2] * Px;
    dB[1] = f[2] * Py;
    dB[2] = f[3] * (cross(rBx, rBy, Px, Py) + axial);
  }
  barrier(a);
  apply_plan(a.sbs, a.j_off, a.j_ent, a.jdelta, p.B);
  barrier(a);
}

// contact warm start of every active contact (the listed ones), at the
// anchors rotated to the current rotation or at the prepare-time anchors
// (S::fixed_warm)
template <class S>
__device__ void contact_warm(const Params& p, World& a) {
  if (a.nc == 0) return;
  const int C = p.C;
  for (int pos = threadIdx.x; pos < a.nc; pos += blockDim.x) {
    const CRow<S> f = contact_row<S>(p, a, pos);
    const int flags = f.flags;
    const float* A = a.sbs + f.ia * 8;
    const float* Bo = a.sbs + f.ib * 8;
    const float nx = f[4], ny = f[5], tx = ny, ty = -nx;
    float Px[2], Py[2], tqA[2], tqB[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const bool pm = flags & (C_PMASK0 << q);
      const float nq = f.n[q * f.is], tq = f.t[q * f.is];
      Px[q] = pm ? nq * nx + tq * tx : 0.0f;
      Py[q] = pm ? nq * ny + tq * ty : 0.0f;
      float rAx, rAy, rBx, rBy;
      contact_anchors<!S::fixed_warm>(f, q, A[5], A[6], Bo[5], Bo[6], &rAx, &rAy, &rBx, &rBy);
      tqA[q] = cross(rAx, rAy, Px[q], Py[q]);
      tqB[q] = cross(rBx, rBy, Px[q], Py[q]);
    }
    const float Ptx = Px[0] + Px[1], Pty = Py[0] + Py[1];
    float* dA = a.cdelta + f.c * 3;
    float* dB = a.cdelta + (C + f.c) * 3;
    dA[0] = (-f[0]) * Ptx;
    dA[1] = (-f[0]) * Pty;
    dA[2] = (-f[1]) * (tqA[0] + tqA[1]);
    dB[0] = f[2] * Ptx;
    dB[1] = f[2] * Pty;
    dB[2] = f[3] * (tqB[0] + tqB[1]);
  }
  barrier(a);
  apply_plan(a.sbs, a.c_off, a.c_ent, a.cdelta, p.B);
  barrier(a);
}

template <class S, bool kBias>
__device__ void solve_passes(const Params& p, World& a) {
  // a biased pass solves the mouse joints too; a relax pass leaves them
  joint_colors<kBias, kBias>(p, a);
  contact_colors<S, kBias>(p, a);
}

// a contact's list group: its color if it is an active winner of a color
// < K, K if it is active otherwise (warm start only), -1 if inactive
__device__ __forceinline__ int contact_group(const int* ci, int K) {
  const int flags = ci[3], color = ci[2];
  if (!(flags & C_ACTIVE)) return -1;
  return ((flags & C_WINNER) && color >= 0 && color < K) ? color : K;
}

// a joint's: its color if it is a planned joint (active, winner, colored)
// of a color < KJ, KJ if planned with a larger color, -1 otherwise
__device__ __forceinline__ int joint_group(const int* ji, int KJ) {
  const int flags = ji[3], color = ji[2];
  if (!((flags & J_ACTIVE) && (flags & J_WINNER) && color >= 0)) return -1;
  return color < KJ ? color : KJ;
}

// group offsets from the counts in cur (groups 0..G), cursors reset to them
__device__ void group_offsets(int* ofs, int* cur, int G) {
  int acc = 0;
  for (int g = 0; g <= G; ++g) {
    ofs[g] = acc;
    acc += cur[g];
    cur[g] = ofs[g];
  }
  ofs[G + 1] = acc;
}

template <class S>
__global__ void __launch_bounds__(kThreads) fused_solve_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int w = blockIdx.x;
  const int B = p.B, C = p.C, J = p.J, K = p.K, KJ = p.KJ;
  const int tid = threadIdx.x, nt = blockDim.x;
  World a;
  a.w = w;
  a.phases = 0;
  a.h = p.scal[0];
  a.inv_h = p.scal[1];
  a.sbs = smem;
  a.sbc = smem + B * 8;
  Carve cv{reinterpret_cast<char*>(smem + B * 16), p.stage_bytes};
  int* gi = p.iscratch + (long long)w * (kScratchHead + C + J);
  auto ints = [&](int n, int* global) {
    int* s = static_cast<int*>(cv.take(n * 4));
    return s ? s : global;
  };
  a.cofs = ints(kGroups, gi);
  a.ccur = ints(kGroups, gi + kGroups);
  a.jofs = ints(kGroups, gi + 2 * kGroups);
  a.jcur = ints(kGroups, gi + 3 * kGroups);
  a.clist = ints(C, gi + kScratchHead);
  a.jlist = ints(J, gi + kScratchHead + C);

  const long long bo = (long long)w * B * 8;
  for (int i = tid; i < B * 8; i += nt) {
    a.sbs[i] = p.bs0[bo + i];
    a.sbc[i] = p.body_const[bo + i];
  }
  for (int g = tid; g < kGroups; g += nt) {
    a.ccur[g] = 0;
    a.jcur[g] = 0;
  }
  // the impulses start as given; staged ones come back at the end
  for (int c = tid; c < C; c += nt) {
    const long long r = ((long long)w * C + c) * 2;
    p.n_out[r] = p.n0[r];
    p.n_out[r + 1] = p.n0[r + 1];
    p.t_out[r] = p.t0[r];
    p.t_out[r + 1] = p.t0[r + 1];
  }
  for (int j = tid; j < J; j += nt) {
    const long long r = ((long long)w * J + j) * 5;
    for (int q = 0; q < 5; ++q) p.jimp_out[r + q] = p.jimp0[r + q];
  }
  const int* cint = p.cint + (long long)w * C * 4;
  const int* jint = p.jint + (long long)w * J * 4;
  barrier(a);

  // the per-color lists: count, offsets, place (atomics order a group's
  // entries freely; the coloring makes that order immaterial)
  for (int c = tid; c < C; c += nt) {
    const int g = contact_group(cint + c * 4, K);
    if (g >= 0) atomicAdd(a.ccur + g, 1);
  }
  for (int j = tid; j < J; j += nt) {
    const int g = joint_group(jint + j * 4, KJ);
    if (g >= 0) atomicAdd(a.jcur + g, 1);
  }
  barrier(a);
  if (tid == 0) {
    group_offsets(a.cofs, a.ccur, K);
    group_offsets(a.jofs, a.jcur, KJ);
  }
  barrier(a);
  a.nc = a.cofs[K + 1];
  a.nj = a.jofs[KJ + 1];

  // stage rows in list order as far as they fit, then the warm-start
  // tables and plans
  a.ncap_c = min(a.nc, cv.fit((S::ncol + 4 + 3) * 4, 3));
  a.scf = static_cast<float*>(cv.take(a.ncap_c * S::ncol * 4));
  a.scimp = static_cast<float*>(cv.take(a.ncap_c * 4 * 4));
  a.sci = static_cast<int*>(cv.take(a.ncap_c * 3 * 4));
  a.ncap_j = min(a.nj, cv.fit((kNJF + 5 + 3) * 4, 3));
  a.sjf = static_cast<float*>(cv.take(a.ncap_j * kNJF * 4));
  a.sjimp = static_cast<float*>(cv.take(a.ncap_j * 5 * 4));
  a.sji = static_cast<int*>(cv.take(a.ncap_j * 3 * 4));
  float* cd = static_cast<float*>(cv.take(2 * C * 3 * 4));
  a.cdelta = cd ? cd : p.cdelta + (long long)w * 2 * C * 3;
  float* jd = static_cast<float*>(cv.take(2 * J * 3 * 4));
  a.jdelta = jd ? jd : p.jdelta + (long long)w * 2 * J * 3;
  const int* gc_off = p.c_off + (long long)w * (B + 1);
  const int* gc_ent = p.c_ent + (long long)w * 2 * C;
  const int* gj_off = p.j_off + (long long)w * (B + 1);
  const int* gj_ent = p.j_ent + (long long)w * 2 * J;
  int* sc_plan = static_cast<int*>(cv.take((B + 1 + 2 * C) * 4));
  int* sj_plan = static_cast<int*>(cv.take((B + 1 + 2 * J) * 4));
  a.c_off = sc_plan ? sc_plan : gc_off;
  a.c_ent = sc_plan ? sc_plan + B + 1 : gc_ent;
  a.j_off = sj_plan ? sj_plan : gj_off;
  a.j_ent = sj_plan ? sj_plan + B + 1 : gj_ent;

  for (int c = tid; c < C; c += nt) {
    const int* ci = cint + c * 4;
    const int g = contact_group(ci, K);
    if (g < 0) continue;
    const int pos = atomicAdd(a.ccur + g, 1);
    a.clist[pos] = c;
    if (pos < a.ncap_c) {
      const long long row = (long long)w * C + c;
      const float* f = p.cfields + row * kNF;
      float* d = a.scf + pos * S::ncol;
#pragma unroll
      for (int k = 0; k < kNF; ++k)
        if (S::reads(k)) d[S::col(k)] = f[k];
      for (int q = 0; q < 2; ++q) {
        a.scimp[q * a.ncap_c + pos] = p.n0[row * 2 + q];
        a.scimp[(2 + q) * a.ncap_c + pos] = p.t0[row * 2 + q];
      }
      a.sci[pos] = ci[0];
      a.sci[a.ncap_c + pos] = ci[1];
      a.sci[2 * a.ncap_c + pos] = ci[3];
    }
  }
  for (int j = tid; j < J; j += nt) {
    const int* ji = jint + j * 4;
    const int g = joint_group(ji, KJ);
    if (g < 0) continue;
    const int pos = atomicAdd(a.jcur + g, 1);
    a.jlist[pos] = j;
    if (pos < a.ncap_j) {
      const long long row = (long long)w * J + j;
      const float* f = p.jfields + row * kNJF;
      float* d = a.sjf + pos * kNJF;
      for (int k = 0; k < kNJF; ++k) d[k] = f[k];
      for (int q = 0; q < 5; ++q) a.sjimp[q * a.ncap_j + pos] = p.jimp0[row * 5 + q];
      a.sji[pos] = ji[0];
      a.sji[a.ncap_j + pos] = ji[1];
      a.sji[2 * a.ncap_j + pos] = ji[3];
    }
  }
  if (sc_plan)
    for (int i = tid; i < B + 1 + 2 * C; i += nt) sc_plan[i] = i <= B ? gc_off[i] : gc_ent[i - B - 1];
  if (sj_plan)
    for (int i = tid; i < B + 1 + 2 * J; i += nt) sj_plan[i] = i <= B ? gj_off[i] : gj_ent[i - B - 1];
  barrier(a);

  if constexpr (S::pgs) {
    integrate_velocities(p, a);
    if (p.warm_start) {
      // the PGS loop warms contacts before joints
      contact_warm<S>(p, a);
      joint_warm(p, a);
    }
    for (int it = 0; it < p.substeps; ++it) solve_passes<S, true>(p, a);
    integrate_positions(p, a);
    for (int r = 0; r < p.relax; ++r) solve_passes<S, false>(p, a);
  } else {
    for (int s = 0; s < p.substeps; ++s) {
      integrate_velocities(p, a);
      if (p.warm_start) {
        joint_warm(p, a);
        contact_warm<S>(p, a);
      }
      solve_passes<S, true>(p, a);
      integrate_positions(p, a);
      if (p.relax) solve_passes<S, false>(p, a);
    }
  }
  for (int pos = tid; pos < a.ncap_c; pos += nt) {
    const long long r = ((long long)w * C + a.clist[pos]) * 2;
    for (int q = 0; q < 2; ++q) {
      p.n_out[r + q] = a.scimp[q * a.ncap_c + pos];
      p.t_out[r + q] = a.scimp[(2 + q) * a.ncap_c + pos];
    }
  }
  for (int pos = tid; pos < a.ncap_j; pos += nt) {
    const long long r = ((long long)w * J + a.jlist[pos]) * 5;
    for (int q = 0; q < 5; ++q) p.jimp_out[r + q] = a.sjimp[q * a.ncap_j + pos];
  }
  for (int i = tid; i < B * 8; i += nt) p.bs_out[bo + i] = a.sbs[i];
  if (tid == 0 && p.phases) p.phases[w] = a.phases;
}

const void* kernel_for(int script) {
  switch (script) {
    case 0:
      return (const void*)fused_solve_kernel<ScriptTgsSoft>;
    case 1:
      return (const void*)fused_solve_kernel<ScriptSoftStep>;
    case 2:
      return (const void*)fused_solve_kernel<ScriptPgsSoft>;
    default:
      return nullptr;
  }
}

template <class S>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fused_solve_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_solve_kernel<S><<<p.W, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes. Launches one block a world of `script`
// (0 TGS_Soft, 1 SoftStep, 2 PGS_Soft) on `stream` with B * 64 +
// `stage_bytes` bytes of shared memory; returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for an unknown script. `relax` counts
// the relax passes: a substep's (0 or 1) in the substep loop, all of them
// in the PGS loop. `iscratch` holds [W, s2t_fused_scratch_ints(C, J)]
// ints; `phases` (or null) receives each world's barrier count.
extern "C" int s2t_fused_solve(const float* body_const, const float* bs0, const float* cfields, const int* cint,
                               const float* n0, const float* t0, const float* jfields, const int* jint,
                               const float* jimp0, const int* c_off, const int* c_ent, const int* j_off,
                               const int* j_ent, const float* scal, float* bs_out, float* n_out, float* t_out,
                               float* jimp_out, float* cdelta, float* jdelta, int* iscratch, int* phases, int W,
                               int B, int C, int J, int K, int KJ, int script, int substeps, int relax,
                               int warm_start, int stage_bytes, void* stream) {
  if (W == 0) return 0;
  if (K > kMaxColors || KJ > kMaxColors || stage_bytes < 0) return (int)cudaErrorInvalidValue;
  Params p{body_const, bs0,      cfields, cint,  n0,       t0,       jfields, jint,     jimp0,
           c_off,      c_ent,    j_off,   j_ent, scal,     bs_out,   n_out,   t_out,    jimp_out,
           cdelta,     jdelta,   iscratch, phases, W,      B,        C,       J,        K,
           KJ,         substeps, relax,   warm_start, stage_bytes & ~15};
  const size_t smem = (size_t)B * 16 * sizeof(float) + (size_t)p.stage_bytes;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (script) {
    case 0:
      return launch<ScriptTgsSoft>(p, smem, st);
    case 1:
      return launch<ScriptSoftStep>(p, smem, st);
    case 2:
      return launch<ScriptPgsSoft>(p, smem, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ints of iscratch a world
extern "C" int s2t_fused_scratch_ints(int C, int J) { return kScratchHead + C + J; }

// the stage_bytes that stage all of a world of B bodies, C contact and J
// joint slots in `script` (the carve of fused_solve_kernel), or -1
extern "C" int s2t_fused_stage_bytes(int script, int B, int C, int J) {
  if (script < 0 || script > 2) return -1;
  const int ncol = script == 0 ? ScriptTgsSoft::ncol : script == 1 ? ScriptSoftStep::ncol : ScriptPgsSoft::ncol;
  auto a16 = [](int n) { return (n + 15) & ~15; };
  return 4 * a16(kGroups * 4) + a16(C * 4) + a16(J * 4) + C * (ncol + 7) * 4 + 48 + J * (kNJF + 8) * 4 + 48 +
         a16(2 * C * 12) + a16(2 * J * 12) + a16((B + 1 + 2 * C) * 4) + a16((B + 1 + 2 * J) * 4);
}

// The compiled kernel of `script`: out[0] registers a thread, out[1] local
// (spill) bytes a thread, out[2] resident blocks an SM with `smem` bytes of
// dynamic shared memory. Returns a cudaError_t.
extern "C" int s2t_fused_attrs(int script, int smem, int* out) {
  const void* fn = kernel_for(script);
  if (!fn) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaFuncAttributes at;
  cudaError_t e = cudaFuncGetAttributes(&at, fn);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = at.numRegs;
  out[1] = (int)at.localSizeBytes;
  out[2] = blocks;
  return 0;
}
