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
// Design. The world's packed body state [B, 8] and its per-body constants
// [B, 8] live in shared memory for the whole solve (64 B a body: 13.5 KB at
// 211 bodies; the freeze gate keeps it under the 227 KB a block may have).
// Contact rows [C, 37] and joint rows [J, 23] stream from global memory,
// and their impulses live in the output arrays, each constraint always
// handled by the same thread (c % blockDim). A color phase lets each thread
// take the constraints of that color that are active and won the body map,
// gather their two body rows from shared memory, run the solve in
// registers and write back only the endpoints it owns; the coloring gives
// every dynamic body at most one such constraint a color, so no two
// threads touch one body, and a block barrier separates the phases. The
// one-hot incidence products of the TPU kernel become these indexed loads
// and stores. The warm start writes each constraint's two deltas to a
// scratch table, then one thread a body adds its deltas in the order the
// wrapper's plan gives (contacts: the JAX scatter's [body_a; body_b] order;
// joints: color order), never with atomics.
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
// chain of a few hundred operations on one constraint per thread; (contact
// + joint colors) per pass, and 4 substeps x 2 passes (TGS_Soft, SoftStep)
// or 4 + 2 passes (PGS_Soft) at the pyramid's configuration. chip_smoke.py
// reports the bound as the larger of the bytes and the operations of this
// run's inputs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr double kPi = 3.14159265359;        // config.PI
constexpr double kMathPi = 3.141592653589793;  // math.pi
constexpr int kNF = 37;                      // contact fields
constexpr int kNJF = 23;                     // joint fields

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
// start at r_a0, r_b0; pgs: the PGS loop (else the substep loop).
struct ScriptTgsSoft {
  static constexpr bool current_anchors = true, sep_from_delta = true, fixed_warm = false, pgs = false;
  static constexpr double clamp = 1.0;
};
struct ScriptSoftStep {
  static constexpr bool current_anchors = false, sep_from_delta = true, fixed_warm = true, pgs = false;
  static constexpr double clamp = 0.5;
};
struct ScriptPgsSoft {
  static constexpr bool current_anchors = false, sep_from_delta = false, fixed_warm = false, pgs = true;
  static constexpr double clamp = 0.5;
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
  int W, B, C, J, K, KJ, substeps, relax, warm_start;
};

// The anchors of a contact's point j: rotated to the current rotation, or
// the prepare-time r_a0, r_b0 (columns 15-22).
template <bool kCurrent>
__device__ __forceinline__ void contact_anchors(const float* f, int j, float qAs, float qAc, float qBs, float qBc,
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
// script's mode) on the rows in shared memory, then its writes.
template <class S, bool kBias>
__device__ void solve_contact(const Params& p, float* sbs, int w, int c, float inv_h) {
  const long long row = (long long)w * p.C + c;
  const float* f = p.cfields + row * kNF;
  const int* ci = p.cint + row * 4;
  const int ia = ci[0], ib = ci[1], flags = ci[3];
  float* A = sbs + ia * 8;
  float* Bo = sbs + ib * 8;
  float vAx = A[0], vAy = A[1], wA = A[2];
  const float dcAx = A[3], dcAy = A[4], qAs = A[5], qAc = A[6];
  float vBx = Bo[0], vBy = Bo[1], wB = Bo[2];
  const float dcBx = Bo[3], dcBy = Bo[4], qBs = Bo[5], qBc = Bo[6];
  const float mA = f[0], iA = f[1], mB = f[2], iB = f[3];
  const float nx = f[4], ny = f[5], fr = f[6];
  const float tx = ny, ty = -nx;
  float* nimp = p.n_out + row * 2;
  float* timp = p.t_out + row * 2;
  float ncol[2] = {nimp[0], nimp[1]};
  float tcol[2] = {timp[0], timp[1]};

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
  nimp[0] = ncol[0];
  nimp[1] = ncol[1];
  timp[0] = tcol[0];
  timp[1] = tcol[1];
}

// _motor_limits' limit(): one side of the soft angle limit
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
__device__ void solve_joint(const Params& p, float* sbs, int w, int j, float h, float inv_h) {
  const long long row = (long long)w * p.J + j;
  const float* f = p.jfields + row * kNJF;
  const int* ji = p.jint + row * 4;
  const int ja = ji[0], jb = ji[1], flags = ji[3];
  const bool mouse = flags & J_MOUSE;
  float* A = sbs + ja * 8;
  float* Bo = sbs + jb * 8;
  float vAx = A[0], vAy = A[1], wA = A[2];
  const float dcAx = A[3], dcAy = A[4], qAs = A[5], qAc = A[6];
  float vBx = Bo[0], vBy = Bo[1], wB = Bo[2];
  const float dcBx = Bo[3], dcBy = Bo[4], qBs = Bo[5], qBc = Bo[6];
  const float mA = f[0], iA = f[1], mB = f[2], iB = f[3];
  const float am = f[10], bc = f[14], mc = f[15], ic = f[16];
  float* imp = p.jimp_out + row * 5;
  const float P0 = imp[0], P1 = imp[1], motor0 = imp[2], lower0 = imp[3], upper0 = imp[4];

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
  imp[1] = P1 + i1;
  imp[2] = motor;
  imp[3] = lower;
  imp[4] = upper;
}

template <bool kBias, bool kMouse>
__device__ void joint_colors(const Params& p, float* sbs, int w, float h, float inv_h) {
  for (int k = 0; k < p.KJ; ++k) {
    for (int j = threadIdx.x; j < p.J; j += blockDim.x) {
      const int* ji = p.jint + ((long long)w * p.J + j) * 4;
      const int flags = ji[3];
      const bool scope = (flags & J_ACTIVE) && (kMouse || !(flags & J_MOUSE));
      if (ji[2] == k && scope && (flags & J_WINNER)) solve_joint<kBias, kMouse>(p, sbs, w, j, h, inv_h);
    }
    __syncthreads();
  }
}

template <class S, bool kBias>
__device__ void contact_colors(const Params& p, float* sbs, int w, float inv_h) {
  for (int k = 0; k < p.K; ++k) {
    for (int c = threadIdx.x; c < p.C; c += blockDim.x) {
      const int* ci = p.cint + ((long long)w * p.C + c) * 4;
      if (ci[2] == k && (ci[3] & C_ACTIVE) && (ci[3] & C_WINNER)) solve_contact<S, kBias>(p, sbs, w, c, inv_h);
    }
    __syncthreads();
  }
}

// each body adds its planned deltas [3] in plan order
__device__ void apply_plan(float* sbs, const int* off, const int* ent, const float* delta, int B) {
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    float* r = sbs + b * 8;
    for (int e = off[b]; e < off[b + 1]; ++e) {
      const float* d = delta + (long long)ent[e] * 3;
      r[0] = r[0] + d[0];
      r[1] = r[1] + d[1];
      r[2] = r[2] + d[2];
    }
  }
}

struct World {
  float* sbs;  // [B, 8] body state (shared)
  float* sbc;  // [B, 8] body constants (shared)
  const int *c_off, *c_ent, *j_off, *j_ent;
  float *cdelta, *jdelta;
  int w;
  float h, inv_h;
};

__device__ void integrate_velocities(const Params& p, const World& a) {
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
  __syncthreads();
}

__device__ void integrate_positions(const Params& p, const World& a) {
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
  __syncthreads();
}

// joint warm start: the deltas of both endpoints of every joint, summed
// into the bodies in plan order
__device__ void joint_warm(const Params& p, const World& a) {
  const int J = p.J;
  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    const long long row = (long long)a.w * J + j;
    const float* f = p.jfields + row * kNJF;
    const int* ji = p.jint + row * 4;
    const float* imp = p.jimp_out + row * 5;
    const float* A = a.sbs + ji[0] * 8;
    const float* Bo = a.sbs + ji[1] * 8;
    float rAx, rAy, rBx, rBy;
    rotate(A[5], A[6], f[4], f[5], &rAx, &rAy);
    rotate(Bo[5], Bo[6], f[6], f[7], &rBx, &rBy);
    const float Px = imp[0], Py = imp[1];
    const float axial = (ji[3] & J_MOUSE) ? imp[2] : imp[2] + imp[3] - imp[4];
    float* dA = a.jdelta + (long long)j * 3;
    float* dB = a.jdelta + (long long)(J + j) * 3;
    dA[0] = (-f[0]) * Px;
    dA[1] = (-f[0]) * Py;
    dA[2] = (-f[1]) * (cross(rAx, rAy, Px, Py) + axial);
    dB[0] = f[2] * Px;
    dB[1] = f[2] * Py;
    dB[2] = f[3] * (cross(rBx, rBy, Px, Py) + axial);
  }
  __syncthreads();
  apply_plan(a.sbs, a.j_off, a.j_ent, a.jdelta, p.B);
  __syncthreads();
}

// contact warm start, at the anchors rotated to the current rotation or at
// the prepare-time anchors (S::fixed_warm)
template <class S>
__device__ void contact_warm(const Params& p, const World& a) {
  const int C = p.C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const long long row = (long long)a.w * C + c;
    const int* ci = p.cint + row * 4;
    const int flags = ci[3];
    if (!(flags & C_ACTIVE)) continue;
    const float* f = p.cfields + row * kNF;
    const float* A = a.sbs + ci[0] * 8;
    const float* Bo = a.sbs + ci[1] * 8;
    const float nx = f[4], ny = f[5], tx = ny, ty = -nx;
    const float* nimp = p.n_out + row * 2;
    const float* timp = p.t_out + row * 2;
    float Px[2], Py[2], tqA[2], tqB[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const bool pm = flags & (C_PMASK0 << q);
      Px[q] = pm ? nimp[q] * nx + timp[q] * tx : 0.0f;
      Py[q] = pm ? nimp[q] * ny + timp[q] * ty : 0.0f;
      float rAx, rAy, rBx, rBy;
      contact_anchors<!S::fixed_warm>(f, q, A[5], A[6], Bo[5], Bo[6], &rAx, &rAy, &rBx, &rBy);
      tqA[q] = cross(rAx, rAy, Px[q], Py[q]);
      tqB[q] = cross(rBx, rBy, Px[q], Py[q]);
    }
    const float Ptx = Px[0] + Px[1], Pty = Py[0] + Py[1];
    float* dA = a.cdelta + (long long)c * 3;
    float* dB = a.cdelta + (long long)(C + c) * 3;
    dA[0] = (-f[0]) * Ptx;
    dA[1] = (-f[0]) * Pty;
    dA[2] = (-f[1]) * (tqA[0] + tqA[1]);
    dB[0] = f[2] * Ptx;
    dB[1] = f[2] * Pty;
    dB[2] = f[3] * (tqB[0] + tqB[1]);
  }
  __syncthreads();
  apply_plan(a.sbs, a.c_off, a.c_ent, a.cdelta, p.B);
  __syncthreads();
}

template <class S, bool kBias>
__device__ void solve_passes(const Params& p, const World& a) {
  // a biased pass solves the mouse joints too; a relax pass leaves them
  joint_colors<kBias, kBias>(p, a.sbs, a.w, a.h, a.inv_h);
  contact_colors<S, kBias>(p, a.sbs, a.w, a.inv_h);
}

template <class S>
__global__ void fused_solve_kernel(Params p) {
  extern __shared__ float smem[];
  const int w = blockIdx.x;
  const int B = p.B, C = p.C, J = p.J;
  World a;
  a.sbs = smem;
  a.sbc = smem + B * 8;
  a.w = w;
  const long long bo = (long long)w * B * 8;
  for (int i = threadIdx.x; i < B * 8; i += blockDim.x) {
    a.sbs[i] = p.bs0[bo + i];
    a.sbc[i] = p.body_const[bo + i];
  }
  // each thread owns the impulses of the constraints it solves
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const long long r = ((long long)w * C + c) * 2;
    p.n_out[r] = p.n0[r];
    p.n_out[r + 1] = p.n0[r + 1];
    p.t_out[r] = p.t0[r];
    p.t_out[r + 1] = p.t0[r + 1];
  }
  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    const long long r = ((long long)w * J + j) * 5;
    for (int q = 0; q < 5; ++q) p.jimp_out[r + q] = p.jimp0[r + q];
  }
  a.h = p.scal[0];
  a.inv_h = p.scal[1];
  a.c_off = p.c_off + (long long)w * (B + 1);
  a.c_ent = p.c_ent + (long long)w * 2 * C;
  a.j_off = p.j_off + (long long)w * (B + 1);
  a.j_ent = p.j_ent + (long long)w * 2 * J;
  a.cdelta = p.cdelta + (long long)w * 2 * C * 3;
  a.jdelta = p.jdelta + (long long)w * 2 * J * 3;
  __syncthreads();

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
  for (int i = threadIdx.x; i < B * 8; i += blockDim.x) p.bs_out[bo + i] = a.sbs[i];
}

template <class S>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fused_solve_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_solve_kernel<S><<<p.W, 256, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes. Launches one block a world of `script`
// (0 TGS_Soft, 1 SoftStep, 2 PGS_Soft) on `stream`; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for an
// unknown script. `relax` counts the relax passes: a substep's (0 or 1) in
// the substep loop, all of them in the PGS loop.
extern "C" int s2t_fused_solve(const float* body_const, const float* bs0, const float* cfields, const int* cint,
                               const float* n0, const float* t0, const float* jfields, const int* jint,
                               const float* jimp0, const int* c_off, const int* c_ent, const int* j_off,
                               const int* j_ent, const float* scal, float* bs_out, float* n_out, float* t_out,
                               float* jimp_out, float* cdelta, float* jdelta, int W, int B, int C, int J, int K,
                               int KJ, int script, int substeps, int relax, int warm_start, void* stream) {
  if (W == 0) return 0;
  Params p{body_const, bs0,  cfields, cint,   n0,     t0, jfields, jint,     jimp0,      c_off,
           c_ent,      j_off, j_ent,   scal,   bs_out, n_out, t_out, jimp_out, cdelta, jdelta,
           W,          B,     C,       J,      K,      KJ, substeps, relax,   warm_start};
  const size_t smem = (size_t)B * 16 * sizeof(float);
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
