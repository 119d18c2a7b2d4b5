"""K1: the fused soft solve as a CUDA kernel (`csrc/fused_solve.cu`).

`fused_solve` runs the kernel on CUDA tensors and the plain twin
(`fused_solve.fused_solve_plain`) on CPU tensors; it never falls back from
one to the other. Replaces the TPU kernel
`solver2d_tpu/solvers/pallas_solver.py:_kernel` in its three scripts
(`scripts.SCRIPTS`: TGS_Soft, SoftStep, PGS_Soft).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..config import K1_BODY_BYTES, K1_SMEM_BYTES
from .fused_solve import N_CONS_FIELDS, N_JOINT_FIELDS, FusedInputs, fused_solve_plain
from .scripts import SCRIPTS, Script

_SOURCE = "fused_solve.cu"
_lib = None


def load():
    """Build (at first use) and load the kernel's library."""
    global _lib
    if _lib is None:
        from .._nvcc import build

        lib = ctypes.CDLL(build([_SOURCE])[_SOURCE])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.s2t_fused_solve.argtypes = [p] * 22 + [i] * 11 + [p]
        lib.s2t_fused_solve.restype = i
        lib.s2t_fused_scratch_ints.argtypes = [i, i]
        lib.s2t_fused_scratch_ints.restype = i
        lib.s2t_fused_stage_bytes.argtypes = [i, i, i, i]
        lib.s2t_fused_stage_bytes.restype = i
        lib.s2t_fused_attrs.argtypes = [i, i, p]
        lib.s2t_fused_attrs.restype = i
        _lib = lib
    return _lib


def _check(t, name, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def stage_bytes_default(script: Script, B: int, C: int, J: int, W: int = 1, device=None) -> int:
    """K1's staging capacity for W worlds of B bodies, C contact and J joint
    slots: what staging all of a world takes (the kernel's own count), up to
    the shared memory a block may have after the bodies. Where the worlds
    outnumber the card's SMs, it is capped so that 2 blocks share an SM: a
    block mostly waits at its barriers, and the other block's phases fill
    that wait. On an H100 at 512 and 4096 worlds that beat staging all (1
    block an SM) and staging less for 3 blocks an SM (PERF.md, section 6)."""
    need = load().s2t_fused_stage_bytes(SCRIPTS.index(script), B, C, J)
    full = max(0, min(K1_SMEM_BYTES - B * K1_BODY_BYTES, need)) // 16 * 16
    if W > torch.cuda.get_device_properties(device).multi_processor_count:
        cap = stage_bytes_for(script, B, 2)
        if cap is not None:
            return min(full, cap)
    return full


@functools.lru_cache(maxsize=None)
def stage_bytes_for(script: Script, B: int, blocks: int) -> int | None:
    """The largest staging capacity (a multiple of 16 bytes) at which
    `blocks` blocks of `script` at B bodies are resident on an SM together,
    or None where the registers alone do not let that many be."""
    room = (K1_SMEM_BYTES - B * K1_BODY_BYTES) // 16

    def fits(units):
        return attributes(script, 16 * units, B)["blocks_per_sm"] >= blocks

    if not fits(0):
        return None
    lo, hi = 0, room
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return 16 * lo


def attributes(script: Script, stage_bytes: int, B: int) -> dict:
    """The compiled kernel of `script` at B bodies and `stage_bytes`:
    registers a thread, shared memory a block, spill bytes a thread,
    resident blocks an SM."""
    lib = load()
    out = (ctypes.c_int * 3)()
    smem = B * K1_BODY_BYTES + stage_bytes
    rc = lib.s2t_fused_attrs(SCRIPTS.index(script), smem, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"K1 attributes: cudaError {rc}")
    return dict(registers=out[0], smem_bytes=smem, spill_bytes=out[1], blocks_per_sm=out[2])


def fused_solve(x: FusedInputs, *, script: Script, substeps: int, relax: int, warm_start: bool,
                n_colors: int, n_joint_colors: int, stage_bytes: int | None = None,
                phases: torch.Tensor | None = None):
    """The solve of W worlds in `script` (layouts in
    `fused_solve.FusedInputs`, arguments as `fused_solve_plain`'s). Returns
    (bs [W, B, 8], n_imp [W, C, 2], t_imp [W, C, 2], jimp [W, J, 5]).
    `stage_bytes` is the kernel's staging capacity (default
    `stage_bytes_default`; any value gives the same result). If `phases`
    ([W] i32 on the card) is given, the kernel writes into it the barriers
    each world's block passed."""
    static = dict(script=script, substeps=substeps, relax=relax, warm_start=warm_start,
                  n_colors=n_colors, n_joint_colors=n_joint_colors)
    dev = x.bs.device
    if dev.type == "cpu":
        return fused_solve_plain(x, **static)
    if dev.type != "cuda":
        raise ValueError(f"fused_solve: unsupported device {dev}")
    W, B = x.bs.shape[:2]
    C, J = x.cint.shape[1], x.jint.shape[1]
    f32, i32 = torch.float32, torch.int32
    for name, dtype, shape in (
        ("body_const", f32, (W, B, 8)), ("bs", f32, (W, B, 8)),
        ("cfields", f32, (W, C, N_CONS_FIELDS)), ("cint", i32, (W, C, 4)),
        ("n_imp", f32, (W, C, 2)), ("t_imp", f32, (W, C, 2)),
        ("jfields", f32, (W, J, N_JOINT_FIELDS)), ("jint", i32, (W, J, 4)), ("jimp", f32, (W, J, 5)),
        ("c_off", i32, (W, B + 1)), ("c_ent", i32, (W, 2 * C)),
        ("j_off", i32, (W, B + 1)), ("j_ent", i32, (W, 2 * J)), ("scal", f32, (2,)),
    ):
        _check(getattr(x, name), name, dtype, shape, dev)
    if phases is not None:
        _check(phases, "phases", i32, (W,), dev)
    if B * K1_BODY_BYTES > K1_SMEM_BYTES:
        raise ValueError(f"fused_solve: {B} bodies exceed the kernel's shared memory")
    if max(n_colors, n_joint_colors) > 30:
        raise ValueError("fused_solve: at most 30 colors")
    if script not in SCRIPTS:
        raise ValueError(f"fused_solve: the kernel is not built for the script {script}")
    if stage_bytes is None:
        stage_bytes = stage_bytes_default(script, B, C, J, W, dev)
    room = K1_SMEM_BYTES - B * K1_BODY_BYTES
    if not 0 <= stage_bytes <= room:
        raise ValueError(f"fused_solve: staging capacity {stage_bytes} outside [0, {room}]")
    if script.loop == "substep" and relax not in (0, 1):
        raise ValueError(f"fused_solve: the substep loop relaxes once a substep or not at all, not {relax} times")
    lib = load()
    bs = torch.empty_like(x.bs)
    n_imp = torch.empty_like(x.n_imp)
    t_imp = torch.empty_like(x.t_imp)
    jimp = torch.empty_like(x.jimp)
    cdelta = torch.empty((W, 2 * C, 3), dtype=f32, device=dev)
    jdelta = torch.empty((W, 2 * J, 3), dtype=f32, device=dev)
    iscratch = torch.empty((W, lib.s2t_fused_scratch_ints(C, J)), dtype=i32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.s2t_fused_solve(
        x.body_const.data_ptr(), x.bs.data_ptr(), x.cfields.data_ptr(), x.cint.data_ptr(),
        x.n_imp.data_ptr(), x.t_imp.data_ptr(), x.jfields.data_ptr(), x.jint.data_ptr(),
        x.jimp.data_ptr(), x.c_off.data_ptr(), x.c_ent.data_ptr(), x.j_off.data_ptr(),
        x.j_ent.data_ptr(), x.scal.data_ptr(),
        bs.data_ptr(), n_imp.data_ptr(), t_imp.data_ptr(), jimp.data_ptr(),
        cdelta.data_ptr(), jdelta.data_ptr(), iscratch.data_ptr(), None if phases is None else phases.data_ptr(),
        W, B, C, J, n_colors, n_joint_colors, SCRIPTS.index(script), substeps, int(relax), int(warm_start),
        int(stage_bytes), stream,
    )
    if rc != 0:
        raise RuntimeError(f"K1 fused solve launch failed: cudaError {rc}")
    fused_solve.launches += 1
    return bs, n_imp, t_imp, jimp


fused_solve.launches = 0
