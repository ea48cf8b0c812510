"""Reference-compatible frame-addressed binary field I/O.

Counterpart of swraytracing_tpu/io/binio.py, byte-for-byte compatible with
the MATLAB direct-access format of qg_flow_ray_trace/write_field.m
(:31-48) and read_field.m (:59-101): float64, column-major within a
frame, frames addressed by seeking unit*nx*ny*nz*(frame-1); complex
fields stored as staggered real/imag blocks with doubled frame stride;
1-based frame numbers on the API (as the reference's analysis scripts
use).

One implementation, in numpy: a frame is one seek and one write, which
is what the JAX package's compiled helper does too, so the files are the
same bytes.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["write_field", "read_field", "frame_count"]


def _binpath(fname) -> str:
    s = str(fname)
    return s if s.endswith(".bin") else s + ".bin"


def write_field(field, fname, frame: int = 1) -> None:
    """Write `field` as 1-based `frame` of fname(.bin).

    Real fields: one float64 block per frame; complex: real block then
    imag block (write_field.m:35-48). Layout within a frame is
    column-major (MATLAB fwrite order). Frames past the end of the file
    leave a zero-filled gap, as the reference's fseek does.
    """
    field = np.asarray(field)
    path = _binpath(fname)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if np.iscomplexobj(field):
        flat = np.concatenate([
            np.ravel(field.real.astype(np.float64), order="F"),
            np.ravel(field.imag.astype(np.float64), order="F")])
    else:
        flat = np.ravel(field.astype(np.float64), order="F")
    mode = "r+b" if os.path.exists(path) else "w+b"
    with open(path, mode) as fh:
        fh.seek(8 * flat.size * (frame - 1))
        fh.write(flat.tobytes())


def read_field(fname, nx: int = 1, ny: int = 1, nz: int = 1, frames=None,
               is_real: bool | None = None):
    """Read frames of fname(.bin); read_field.m semantics.

    nx == 1: the whole file as a 0-d time series (1-D array).
    Otherwise returns (nx, ny, nz, nframes) squeezed, column-major
    decoded. is_real defaults to the reference's heuristic
    nx == 2*ny - 1 => complex (read_field.m:37-41).
    """
    path = _binpath(fname)
    if nx == 1 and ny == 1 and nz == 1:
        return np.fromfile(path, dtype=np.float64)
    if is_real is None:
        is_real = not (nx == 2 * ny - 1)
    if frames is None:
        frames = [1]
    frames = np.atleast_1d(np.asarray(frames, np.int64))
    n = nx * ny * nz
    stride = n if is_real else 2 * n
    out = np.empty((len(frames), stride), np.float64)
    with open(path, "rb") as fh:
        for j, frm in enumerate(frames):
            fh.seek(8 * stride * (int(frm) - 1))
            buf = fh.read(8 * stride)
            if len(buf) != 8 * stride:
                raise OSError(f"{path}: frame {int(frm)} is past the end "
                              "of the file")
            out[j] = np.frombuffer(buf, np.float64)
    data = out if is_real else out[:, :n] + 1j * out[:, n:]
    field = np.stack([
        d.reshape((nx, ny, nz), order="F") for d in data], axis=-1)
    return np.squeeze(field)


def frame_count(fname, nx: int, ny: int = 1, nz: int = 1,
                is_real: bool = True) -> int:
    """Complete frames currently in the file (checkpoint-resume aid)."""
    path = _binpath(fname)
    if not os.path.exists(path):
        return 0
    stride = nx * ny * nz * (1 if is_real else 2)
    return os.path.getsize(path) // (8 * stride)
