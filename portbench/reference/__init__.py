"""The plain reference the benchmark judges the port against.

A frozen copy of the plain algorithm, in plain PyTorch, written for
clarity and float64, and independent of the code under test: it imports
nothing of `swraytracing_torch`, `jax` or `swraytracing_tpu`, and works
out again from the seed and the program's carried state whatever the
port's set-up derives (dt, the operators, the initial fields, the
velocity grids). Each module names the port file and commit its
arithmetic was copied from (commit 701921e).

  spectral  the rfft2 grid, transforms and the aliased Jacobian
  qg        the one-layer QG step (AB3 + filter), ring IC, max speed
  qg2       the two-layer QG step (integrating-factor AB3), ring IC,
            top-layer velocity, max speed
  stencil   the 6x6 Lagrange stencil on a periodic grid: velocity and its
            gradient (the interpolant's derivative) at packet positions
  rays      the time-blended rk23 substeps of one flow step
  hist      the omega histogram
  coupled   the lock-step: the flow's steps, then the packets in blocks
  packets   the packets' initial conditions

`lowp` rounds a tensor to bfloat16 and back: the control (the reference
in a precision below float32, put in the program's place) passes it as
`rnd` wherever the state or a grid is stored.
"""

import torch


def exact(t):
    return t


def lowp(t):
    """`t` rounded to bfloat16 storage, returned in its own dtype (complex
    tensors part by part)."""
    if t.is_complex():
        r = torch.view_as_real(t).to(torch.bfloat16).to(t.real.dtype)
        return torch.view_as_complex(r.contiguous())
    return t.to(torch.bfloat16).to(t.dtype)
