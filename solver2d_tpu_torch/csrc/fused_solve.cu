// K1: the fused soft solve of the per-world step on Hopper (sm_90a).
//
// Replaces the TPU kernel solver2d_tpu/solvers/pallas_solver.py:_kernel
// (launched by fused_solve, pallas_solver.py:428) in its TGS_Soft script
// (loop="substep", fixed_warm=False; reference: src/solve_tgs_soft.c:138-280).
// One block solves one world: per substep it integrates velocities, warm
// starts the joints and then the contacts, runs one colored pass over the
// soft revolute and mouse joints and one over the contacts, integrates
// positions, and relaxes with one more pass of each (no bias, mouse joints
// left alone).
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
// Numbers. The operation order is that of the plain twin
// (solver2d_tpu_torch/solvers/fused_solve.py:fused_solve_plain, which calls
// contact_kernels.solve_contact_core and joints.solve_joint_core); built
// with -fmad=false and IEEE division and square root, without fast math or
// flush-to-zero, the kernel rounds as the twin does, and its atan2 is the
// package's polynomial. Constants are double literals cast to float, as
// PyTorch casts a Python scalar.
//
// Bound. Per world the function must read the int row of every constraint
// slot (4 words), the 27 float columns the solve reads of each active
// contact (not r_a0, r_b0, separation) and its 4 impulses, the 23 columns
// and 5 impulses of each live joint, the body rows (16 words), and write
// the bodies and those impulses: at 64 worlds x 896 slots (590 active) x
// 211 bodies about 7.5 MB, a few microseconds at 3.35 TB/s. Its
// floating-point work is a few hundred operations per constraint and pass.
// What bounds it is latency: 4 substeps x 2 passes x (contact colors +
// joint colors) barrier-separated phases (144 at 10 + 8 colors), each a
// dependent chain of a few hundred operations on one constraint per thread. chip_smoke.py reports the bound
// as the larger of the bytes and the operations of this run's inputs.

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

// One contact's soft TGS solve (contact_kernels.solve_contact_core, mode
// TGS_SOFT) on the rows in shared memory, then its writes.
template <bool kBias>
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
    rotate(qAs, qAc, f[7 + 2 * j], f[8 + 2 * j], &rAx, &rAy);
    rotate(qBs, qBc, f[11 + 2 * j], f[12 + 2 * j], &rBx, &rBy);
    const float dsx = (dcBx - dcAx) + (rBx - rAx);
    const float dsy = (dcBy - dcAy) + (rBy - rAy);
    const float s = (dsx * nx + dsy * ny) + f[25 + j];
    const bool spec = s > 0.0f;
    float bias, mass_scale, imp_scale;
    if (kBias) {
      const float bias_pen = fmaxf(f[31 + j] * s, F(-1.0 * 4.0));
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
    rotate(qAs, qAc, f[7 + 2 * j], f[8 + 2 * j], &rAx, &rAy);
    rotate(qBs, qBc, f[11 + 2 * j], f[12 + 2 * j], &rBx, &rBy);
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

template <bool kBias>
__device__ void contact_colors(const Params& p, float* sbs, int w, float inv_h) {
  for (int k = 0; k < p.K; ++k) {
    for (int c = threadIdx.x; c < p.C; c += blockDim.x) {
      const int* ci = p.cint + ((long long)w * p.C + c) * 4;
      if (ci[2] == k && (ci[3] & C_ACTIVE) && (ci[3] & C_WINNER)) solve_contact<kBias>(p, sbs, w, c, inv_h);
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

__global__ void fused_solve_kernel(Params p) {
  extern __shared__ float smem[];
  const int w = blockIdx.x;
  const int B = p.B, C = p.C, J = p.J;
  float* sbs = smem;          // [B, 8] body state
  float* sbc = smem + B * 8;  // [B, 8] body constants
  const long long bo = (long long)w * B * 8;
  for (int i = threadIdx.x; i < B * 8; i += blockDim.x) {
    sbs[i] = p.bs0[bo + i];
    sbc[i] = p.body_const[bo + i];
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
  const float h = p.scal[0], inv_h = p.scal[1];
  const int* c_off = p.c_off + (long long)w * (B + 1);
  const int* c_ent = p.c_ent + (long long)w * 2 * C;
  const int* j_off = p.j_off + (long long)w * (B + 1);
  const int* j_ent = p.j_ent + (long long)w * 2 * J;
  float* cdelta = p.cdelta + (long long)w * 2 * C * 3;
  float* jdelta = p.jdelta + (long long)w * 2 * J * 3;
  __syncthreads();

  for (int s = 0; s < p.substeps; ++s) {
    // integrate velocities
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
      float* r = sbs + b * 8;
      const float* k = sbc + b * 8;
      if (k[0] > 0.0f) {
        const float hm = h * k[2];
        r[0] = (r[0] + hm * k[3]) * k[6];
        r[1] = (r[1] + hm * k[4]) * k[6];
        r[2] = (r[2] + h * k[5]) * k[7];
      }
    }
    __syncthreads();
    if (p.warm_start) {
      // joint warm start: the deltas of both endpoints of every joint
      for (int j = threadIdx.x; j < J; j += blockDim.x) {
        const long long row = (long long)w * J + j;
        const float* f = p.jfields + row * kNJF;
        const int* ji = p.jint + row * 4;
        const float* imp = p.jimp_out + row * 5;
        const float* A = sbs + ji[0] * 8;
        const float* Bo = sbs + ji[1] * 8;
        float rAx, rAy, rBx, rBy;
        rotate(A[5], A[6], f[4], f[5], &rAx, &rAy);
        rotate(Bo[5], Bo[6], f[6], f[7], &rBx, &rBy);
        const float Px = imp[0], Py = imp[1];
        const float axial = (ji[3] & J_MOUSE) ? imp[2] : imp[2] + imp[3] - imp[4];
        float* dA = jdelta + (long long)j * 3;
        float* dB = jdelta + (long long)(J + j) * 3;
        dA[0] = (-f[0]) * Px;
        dA[1] = (-f[0]) * Py;
        dA[2] = (-f[1]) * (cross(rAx, rAy, Px, Py) + axial);
        dB[0] = f[2] * Px;
        dB[1] = f[2] * Py;
        dB[2] = f[3] * (cross(rBx, rBy, Px, Py) + axial);
      }
      __syncthreads();
      apply_plan(sbs, j_off, j_ent, jdelta, B);
      __syncthreads();
      // contact warm start with the anchors at the current rotation
      for (int c = threadIdx.x; c < C; c += blockDim.x) {
        const long long row = (long long)w * C + c;
        const int* ci = p.cint + row * 4;
        const int flags = ci[3];
        if (!(flags & C_ACTIVE)) continue;
        const float* f = p.cfields + row * kNF;
        const float* A = sbs + ci[0] * 8;
        const float* Bo = sbs + ci[1] * 8;
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
          rotate(A[5], A[6], f[7 + 2 * q], f[8 + 2 * q], &rAx, &rAy);
          rotate(Bo[5], Bo[6], f[11 + 2 * q], f[12 + 2 * q], &rBx, &rBy);
          tqA[q] = cross(rAx, rAy, Px[q], Py[q]);
          tqB[q] = cross(rBx, rBy, Px[q], Py[q]);
        }
        const float Ptx = Px[0] + Px[1], Pty = Py[0] + Py[1];
        float* dA = cdelta + (long long)c * 3;
        float* dB = cdelta + (long long)(C + c) * 3;
        dA[0] = (-f[0]) * Ptx;
        dA[1] = (-f[0]) * Pty;
        dA[2] = (-f[1]) * (tqA[0] + tqA[1]);
        dB[0] = f[2] * Ptx;
        dB[1] = f[2] * Pty;
        dB[2] = f[3] * (tqB[0] + tqB[1]);
      }
      __syncthreads();
      apply_plan(sbs, c_off, c_ent, cdelta, B);
      __syncthreads();
    }
    joint_colors<true, true>(p, sbs, w, h, inv_h);
    contact_colors<true>(p, sbs, w, inv_h);
    // integrate positions
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
      float* r = sbs + b * 8;
      if (sbc[b * 8 + 1] > 0.0f) {
        r[3] = r[3] + h * r[0];
        r[4] = r[4] + h * r[1];
        const float oh = h * r[2];
        const float qs = r[5] + oh * r[6];
        const float qc = r[6] - oh * r[5];
        const float mag = sqrtf(qs * qs + qc * qc);
        const float inv = mag > 0.0f ? 1.0f / fmaxf(mag, F(1e-30)) : 0.0f;
        r[5] = qs * inv;
        r[6] = qc * inv;
      }
    }
    __syncthreads();
    if (p.relax) {
      joint_colors<false, false>(p, sbs, w, h, inv_h);
      contact_colors<false>(p, sbs, w, inv_h);
    }
  }
  for (int i = threadIdx.x; i < B * 8; i += blockDim.x) p.bs_out[bo + i] = sbs[i];
}

}  // namespace

// C interface, bound with ctypes. Launches one block a world on `stream`;
// returns cudaGetLastError() (0 on success).
extern "C" int s2t_fused_solve(const float* body_const, const float* bs0, const float* cfields, const int* cint,
                               const float* n0, const float* t0, const float* jfields, const int* jint,
                               const float* jimp0, const int* c_off, const int* c_ent, const int* j_off,
                               const int* j_ent, const float* scal, float* bs_out, float* n_out, float* t_out,
                               float* jimp_out, float* cdelta, float* jdelta, int W, int B, int C, int J, int K,
                               int KJ, int substeps, int relax, int warm_start, void* stream) {
  if (W == 0) return 0;
  Params p{body_const, bs0,  cfields, cint,   n0,     t0, jfields, jint,     jimp0,      c_off,
           c_ent,      j_off, j_ent,   scal,   bs_out, n_out, t_out, jimp_out, cdelta, jdelta,
           W,          B,     C,       J,      K,      KJ, substeps, relax,   warm_start};
  const size_t smem = (size_t)B * 16 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fused_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_solve_kernel<<<W, 256, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
