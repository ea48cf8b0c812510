"""The numbers compared: hist_moved_early reads one member's first rows
on their own, where a fault in one member is not diluted by the others
or by the later rows."""

import torch

from portbench import compare


def test_hist_moved_early_reads_the_worst_member_early():
    n, E, saves, bins = 100, 3, 20, 8
    ref = torch.zeros(E, saves, bins)
    ref[..., 0] = n
    prog = ref.clone()
    prog[1, 0, 0], prog[1, 0, 1] = n - 10, 10    # member 1, first row
    prog[2, 15, 0], prog[2, 15, 2] = n - 50, 50  # member 2, a late row
    assert compare.hist_moved_early(prog, ref, n, 4) == 10 / (n * 4)
    assert compare.hist_moved_early(prog, ref, n, 20) == 50 / (n * 20)
    # all rows of all members together dilute both
    assert compare.hist_moved(prog, ref, n) == 60 / (n * E * saves)
    # a single run's rows (saves, bins) are one member
    assert compare.hist_moved_early(prog[1], ref[1], n, 1) == 10 / n
