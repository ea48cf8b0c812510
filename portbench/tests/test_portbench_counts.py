"""K1's operation and byte counts: the operations are chip_smoke.py's at
the main shape, the bytes a hand count of the algorithm's own traffic,
and neither depends on how a kernel lays out its windows."""

from swraytracing_torch.ops.march_window import MarchSpec

import conftest  # noqa: F401

from portbench.counts import march


def main_spec(**kw):
    base = dict(nx=512, ny=512, dx=20 / 512, dy=20 / 512, f=3.0, Cg=1.0,
                n_substeps=2, stepper="rk23", margin=1, nf=2,
                grad_from_interp=True, tiles_transposed=True)
    return MarchSpec(**dict(base, **kw))


def test_main_shape_counts():
    spec = main_spec()
    assert march.flops(spec, 2 ** 20) == 5897191424
    # u, v of both snapshots at 512^2 in float32; x and k (4 numbers) of
    # 2^20 packets read and written; one overflow word
    assert march.bytes_moved(spec, 2 ** 20, 1, 4) == \
        2 * 2 * 512 * 512 * 4 + 2 ** 20 * 16 * 2 + 4
    assert march.bound_s(march.flops(spec, 2 ** 20),
                         march.bytes_moved(spec, 2 ** 20, 1, 4)) == \
        5897191424 / 67e12


def test_ensemble_counts():
    spec = main_spec(nx=256, ny=256, dx=0.0245, dy=0.0245)
    assert march.flops(spec, 12 * 2 ** 14) == 12 * 2 ** 14 * 5624
    assert march.bytes_moved(spec, 12 * 2 ** 14, 12, 4) == \
        12 * 2 * 2 * 256 * 256 * 4 + 12 * 2 ** 14 * 32 + 12 * 4


def test_counts_ignore_the_window_layout():
    a = main_spec()
    for b in (main_spec(margin=3), main_spec(tiles_transposed=False),
              main_spec(fused_build=True), main_spec(block=128)):
        assert march.flops(b, 1000) == march.flops(a, 1000)
        assert march.bytes_moved(b, 1000, 1, 4) == \
            march.bytes_moved(a, 1000, 1, 4)
