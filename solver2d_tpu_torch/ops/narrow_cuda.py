"""K2: the lane-batched narrowphase as a CUDA kernel (`csrc/narrow.cu`).

`collide` runs the kernel on CUDA tensors and the plain twin
(`narrow_lanes.collide_lanes_plain`) on CPU tensors; it never falls back from
one to the other. Replaces the TPU kernel
`solver2d_tpu/ops/narrow_pallas.py:_kernel`.
"""

from __future__ import annotations

import ctypes

import torch

from .narrow_lanes import collide_lanes_plain

_SOURCE = "narrow.cu"
_lib = None


def load():
    """Build (at first use) and load the kernel's library."""
    global _lib
    if _lib is None:
        from .._nvcc import build

        lib = ctypes.CDLL(build([_SOURCE])[_SOURCE])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.s2t_collide_lanes.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, p]
        lib.s2t_collide_lanes.restype = i
        lib.s2t_collide_attrs.argtypes = [i, p]
        lib.s2t_collide_attrs.restype = i
        _lib = lib
    return _lib


def attributes(W: int) -> dict:
    """The compiled kernel that a batch of W worlds launches: registers a
    thread, shared memory a block, spill bytes a thread, resident blocks an
    SM, and its block's tile (slots x worlds)."""
    out = (ctypes.c_int * 6)()
    rc = load().s2t_collide_attrs(W, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"K2 attributes: cudaError {rc}")
    return dict(registers=out[0], smem_bytes=out[1], spill_bytes=out[2], blocks_per_sm=out[3],
                tile=(out[4], out[5]))


def _check(t, name, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def collide(geom, sa, sb, pa, pb, cache, gjk_iters: int):
    """Narrowphase of a lockstep batch. geom [S, 34] f32 shape table; sa, sb
    [C] i32 shared shape indices; pa, pb [W, 4, C] f32 poses; cache
    [W, 7, C] i32 GJK cache. Returns fout [W, 12, C] f32, iout [W, 3, C] i32,
    cout [W, 7, C] i32 (layouts in `narrow_lanes.collide_lanes_plain`)."""
    dev = geom.device
    if dev.type == "cpu":
        return collide_lanes_plain(geom, sa, sb, pa, pb, cache, gjk_iters)
    if dev.type != "cuda":
        raise ValueError(f"collide: unsupported device {dev}")
    S = geom.shape[0]
    W, _, C = pa.shape
    _check(geom, "geom", torch.float32, (S, 34), dev)
    _check(sa, "sa", torch.int32, (C,), dev)
    _check(sb, "sb", torch.int32, (C,), dev)
    _check(pa, "pa", torch.float32, (W, 4, C), dev)
    _check(pb, "pb", torch.float32, (W, 4, C), dev)
    _check(cache, "cache", torch.int32, (W, 7, C), dev)
    if W * C >= 2**31:
        raise ValueError("collide: W * C must fit int32")
    if geom.data_ptr() % 8:
        raise ValueError("geom: the kernel reads its rows in 8-byte loads; its data must be 8-byte aligned")
    lib = load()
    fout = torch.empty((W, 12, C), dtype=torch.float32, device=dev)
    iout = torch.empty((W, 3, C), dtype=torch.int32, device=dev)
    cout = torch.empty((W, 7, C), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.s2t_collide_lanes(
        geom.data_ptr(), sa.data_ptr(), sb.data_ptr(), pa.data_ptr(), pb.data_ptr(),
        cache.data_ptr(), fout.data_ptr(), iout.data_ptr(), cout.data_ptr(),
        W, C, int(gjk_iters), stream,
    )
    if rc != 0:
        raise RuntimeError(f"K2 narrowphase launch failed: cudaError {rc}")
    collide.launches += 1
    return fout, iout, cout


collide.launches = 0
