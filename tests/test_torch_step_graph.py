"""The chunk loop's two routes (models/step_graph.py, chosen in
models/coupled.run_lockstep_chunk): the rule that picks them, and on the
card the graph route against the eager loop.

On the CPU every chunk takes the eager loop: the rule names each condition
that refuses the graph route, the eager steps are counted, and a chunk
gives the eager loop's bits. The tests marked `card` need a CUDA device
and skip without one; they hold the graph route to the eager loop bit for
bit, chunk after chunk, from kept carries, and a replay's kernels in a
device trace to the eager loop's wrapper launches.
This file imports no JAX, so on a machine with a card it runs by itself:

    python -m pytest tests/test_torch_step_graph.py --noconftest -q
"""

import dataclasses
import json
import re

import pytest
import torch

from swraytracing_torch.analysis.device_diag import (OmegaHistSpec,
                                                     omega_hist_counts)
from swraytracing_torch.models import coupled as tcp
from swraytracing_torch.models import coupled2 as tc2
from swraytracing_torch.models import step_graph as sg
from swraytracing_torch.ops import march_window as mw
from swraytracing_torch.parallel import ensemble as tens
from swraytracing_torch.utils import profiling

PER_SAVE, N_SAVES = 3, 2
SMALL = dict(nx=32, n_packets=64, T_Fr_days=10.0, packet_delay_days=0.01,
             packet_steps_per_save=PER_SAVE, window_min_np=1)
# the two-layer main path's shape (cell qg2_512.p1m)
MAIN = dict(nx=512, n_packets=2 ** 20, T_Fr_days=6000.0,
            packet_delay_days=0.01, U_g=0.4, packet_steps_per_save=25)
CPU = dict(device="cpu", dtype=torch.float64)

MODELS = {
    "two_layer": (tc2.Coupled2Config, tc2.setup_coupled2,
                  tc2.run_coupled2_chunk, tc2.coupled2_flow_packet_step),
    "one_layer": (tcp.CoupledConfig, tcp.setup_coupled,
                  tcp.run_coupled_chunk, tcp.coupled_flow_packet_step),
}


def _hist(carry):
    spec = OmegaHistSpec(n_bins=47, omega_max=12.0, f=3.0, Cg=1.0)
    return omega_hist_counts(carry.packet_k, spec)


def _model(name, sizes=SMALL, device="cpu", dtype=torch.float64, **over):
    """(cfg, setup, initial carry, the chunk entry, the step function)."""
    Cfg, setup, run, step = MODELS[name]
    cfg = Cfg(**{**sizes, **over})
    s, c = setup(cfg, device=device, dtype=dtype)
    return cfg, s, c, run, step


def _eager(c, s, cfg, step, n_saves, diag_fn=None):
    """The chunk by the eager loop: a step function that is not a
    ModelStep shows no setup, so the graph route refuses it."""
    return tcp.run_lockstep_chunk(
        c, lambda c: step(c, s, cfg), s.march, cfg.packet_steps_per_save,
        n_saves, diag_fn=diag_fn, window_min_np=cfg.window_min_np)


def _answers(carry, out):
    """Every leaf of the carry (tensors and host values) and the saves."""
    return [v for _, v in sg._leaves(carry)] + list(out)


def _require_same_bits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, torch.Tensor):
            assert isinstance(g, torch.Tensor) and g.dtype == w.dtype
            assert g.shape == w.shape and torch.equal(g, w)
        else:
            assert type(g) is type(w) and g == w


def _clones(answers):
    return [v.clone() if isinstance(v, torch.Tensor) else v
            for v in answers]


def _routes_since(before):
    return {k: sg.ROUTES[k] - before[k] for k in sg.ROUTES}


# the lock-step's kernel wrappers, and their kernels by name in a device
# trace
WRAPPERS = {"march": mw.march_gathered_cuda, "transpose": mw.transpose_cuda,
            "build_windows": mw.build_windows_cuda}
KERNELS = {"march": r"\bmarch(_ring)?_kernel\b",
           "transpose": r"\btranspose_kernel\b",
           "build_windows": r"\bbuild_windows_kernel\b"}


def _launches():
    """The wrappers' counters: launches, the march's by route and the
    transpose's by direction."""
    out = {k: w.launches for k, w in WRAPPERS.items()}
    out.update({f"march.{r}": n for r, n in
                mw.march_gathered_cuda.launches_by_route.items()})
    out.update({f"transpose.{d}": n for d, n in
                mw.transpose_cuda.launches_by_direction.items()})
    return out


def _launches_since(before):
    return {k: n - before[k] for k, n in _launches().items()}


def _kernel_records(fn, tmp_path):
    """fn() under torch.profiler: (its result, the device trace's records
    of each of KERNELS)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [e.get("name", "") for e in
             json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "kernel"]
    return out, {k: sum(1 for n in names if re.search(rx, n))
                 for k, rx in KERNELS.items()}


# ---------------------------------------------------------------------------
# the CPU: the rule, the count, the bits
# ---------------------------------------------------------------------------

def _past_bootstrap(name="two_layer", **over):
    """A chunk's inputs after one chunk: flow step 3, packets released."""
    cfg, s, c, run, step = _model(name, **over)
    c, _ = run(c, s, cfg, 1)
    return c, sg.ModelStep(step, s, cfg), s.march


def _grad_carry(c):
    qk = c.flow_state.qk.detach().clone().requires_grad_(True)
    return dataclasses.replace(
        c, flow_state=dataclasses.replace(c.flow_state, qk=qk))


def _ensemble_case():
    base = tcp.CoupledConfig(**SMALL)
    s, _, c = tens.setup_ensemble(
        tens.sweep_configs(base, (2.0, 8.0), (0.3, 0.9)), **CPU)
    return c, sg.ModelStep(tcp.coupled_flow_packet_step, s, base), s.march


def _initial():
    cfg, s, c, _, step = _model("two_layer")
    return c, sg.ModelStep(step, s, cfg), s.march


# case -> (inputs of refusals, grad mode, the refusals named)
RULE = {
    "on the card it engages": (
        lambda: (*_past_bootstrap(), False, 3), True, []),
    "remat": (lambda: (*_past_bootstrap(), True, 3), True, ["remat"]),
    "a carry tensor requires grad": (
        lambda: ((lambda c, f, m: (_grad_carry(c), f, m, False, 3))(
            *_past_bootstrap())), True, ["grad"]),
    "it requires grad with grad mode off": (
        lambda: ((lambda c, f, m: (_grad_carry(c), f, m, False, 3))(
            *_past_bootstrap())), False, []),
    "an ensemble's carry": (lambda: (*_ensemble_case(), False, 3), True,
                            ["ensemble"]),
    "the march is off": (
        lambda: (*_past_bootstrap(fused_march=False), False, 3), True,
        ["no_march"]),
    "a step function with no setup": (
        lambda: ((lambda c, f, m: (c, lambda x: f(x), m, False, 3))(
            *_past_bootstrap())), True, ["step_fn"]),
    "no steps": (lambda: (*_past_bootstrap(), False, 0), True,
                 ["no_steps"]),
    "the flow's bootstrap": (lambda: (*_initial(), False, 3), True,
                             ["bootstrap"]),
    "before release": (
        lambda: (*_past_bootstrap(packet_delay_days=1000.0), False, 3), True,
        ["unreleased"]),
}


@pytest.mark.parametrize("case", list(RULE))
def test_rule_names_each_refusal(case):
    """Each condition of the graph route refuses it by its own name; on
    the CPU "not_cuda" is always among them."""
    make, grad, named = RULE[case]
    args = make()
    with torch.set_grad_enabled(grad):
        got = sg.refusals(*args)
    assert got == ["not_cuda"] + named


@pytest.mark.parametrize("path", ["two_layer", "one_layer", "remat",
                                  "per_stage", "diag"])
def test_routes_count_the_eager_steps(path):
    """On the CPU every chunk runs the eager loop, counted a step each, and
    no graph is captured."""
    name = "one_layer" if path == "one_layer" else "two_layer"
    over = dict(fused_march=False) if path == "per_stage" else {}
    cfg, s, c, run, _ = _model(name, **over)
    kw = {"remat": True} if path == "remat" else {}
    if path == "diag":
        kw["diag_fn"] = _hist
    before = dict(sg.ROUTES)
    c, _ = run(c, s, cfg, N_SAVES, **kw)
    run(c, s, cfg, 1, **kw)
    assert _routes_since(before) == {"graph": 0, "captures": 0,
                                     "eager": (N_SAVES + 1) * PER_SAVE}
    assert len(sg._CACHE) == 0


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("diag", [False, True])
def test_chunk_is_the_eager_loop_bit_for_bit(name, diag):
    """Both models' chunks, from the start and past the bootstrap, give the
    bits of the eager loop run by hand, and leave their input as it was."""
    cfg, s, c, run, step = _model(name)
    kept = _clones(_answers(c, ()))
    ce = cg = c
    diag_fn = _hist if diag else None
    for _ in range(3):
        cg, og = run(cg, s, cfg, N_SAVES, diag_fn=diag_fn)
        ce, oe = _eager(ce, s, cfg, step, N_SAVES, diag_fn)
        _require_same_bits(_answers(cg, og), _answers(ce, oe))
    _require_same_bits(_answers(c, ()), kept)


@pytest.mark.parametrize("name", list(MODELS))
def test_host_advance_is_the_steps_own(name):
    """What a replay sets `t` and `step` to is what the steps give."""
    cfg, s, c, run, _ = _model(name)
    c1, _ = run(c, s, cfg, 1)
    c2, _ = run(c1, s, cfg, N_SAVES)
    host = {p: v for p, v in sg._leaves(c1)
            if not isinstance(v, torch.Tensor)}
    want = {p: v for p, v in sg._leaves(c2)
            if not isinstance(v, torch.Tensor)}
    got = sg._advance(host, N_SAVES * PER_SAVE, s.dt)
    assert got == want and type(got[sg._T]) is type(want[sg._T])


def _apart_case(case):
    """(out, inputs) for _apart: leaves {path: value} as a capture's steps
    leave them, and the input buffers."""
    a, b = torch.arange(4.0), torch.arange(4.0) + 10
    inputs = {("a",): a, ("b",): b}
    outs = {
        "a fresh tensor": {("a",): torch.ones(4), ("b",): b, ("t",): 0.5},
        "its own input": {("a",): a, ("b",): b * 2, ("t",): 0.5},
        "another input": {("a",): b, ("b",): a, ("t",): 0.5},
        "a view of another input": {("a",): b[:], ("b",): b * 2,
                                    ("t",): 0.5},
    }
    return outs[case], inputs


@pytest.mark.parametrize("case", ["a fresh tensor", "its own input",
                                  "another input",
                                  "a view of another input"])
def test_apart_clones_what_shares_another_inputs_memory(case):
    """A tensor the steps left that shares memory with an input buffer
    other than its own leaf's is cloned, so that copying the outputs into
    the inputs reads nothing it has written; every other leaf is passed
    on as it is."""
    out, inputs = _apart_case(case)
    got = sg._apart(out, inputs)
    assert set(got) == set(out) and got[("t",)] == 0.5
    ptrs = {v.untyped_storage().data_ptr() for v in inputs.values()}
    for p, v in out.items():
        if not isinstance(v, torch.Tensor):
            continue
        assert torch.equal(got[p], v)
        shares = v.untyped_storage().data_ptr() in ptrs
        if v is inputs.get(p) or not shares:
            assert got[p] is v
        else:
            assert got[p].untyped_storage().data_ptr() not in ptrs
    # the inputs copied from the outputs, in turn, as between replays,
    # end with the outputs' values
    want = {p: out[p].clone() for p in inputs}
    for p, buf in inputs.items():
        if got[p] is not buf:
            buf.copy_(got[p])
    for p, buf in inputs.items():
        assert torch.equal(buf, want[p])


def test_apart_refuses_a_step_that_changes_the_carrys_tensors():
    a = torch.arange(4.0)
    with pytest.raises(RuntimeError, match="keeps the carry's tensors"):
        sg._apart({("a",): torch.ones(5)}, {("a",): a})


# ---------------------------------------------------------------------------
# the card: the graph route against the eager loop
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


CARD_CASES = {
    "two_layer_main": ("two_layer", MAIN, torch.float32, {}),
    "two_layer_small": ("two_layer", SMALL, torch.float32, {}),
    "two_layer_small_f64": ("two_layer", SMALL, torch.float64, {}),
    "one_layer_small": ("one_layer", SMALL, torch.float32, {}),
    "one_layer_small_fused_build": ("one_layer", SMALL, torch.float32,
                                    {"march_fused_build": True}),
}


@pytest.mark.card
@pytest.mark.parametrize("case", list(CARD_CASES))
@pytest.mark.parametrize("diag", [False, True])
def test_graph_route_is_the_eager_loop(card, case, diag, tmp_path):
    """Three chunks from the start: the first runs the bootstrap eagerly,
    the next two replay one captured graph a save. Every leaf of the carry,
    every save and every save time equal the eager loop's bit for bit. The
    wrappers count what runs when they are called: the first chunk's
    launches as the eager loop's, the second's the one step run before the
    capture, the third's none; the third's kernels in a device trace are
    the eager chunk's wrapper launches, kernel by kernel."""
    name, sizes, dtype, over = CARD_CASES[case]
    cfg, s, c, run, step = _model(name, sizes, card, dtype, **over)
    per_save = cfg.packet_steps_per_save
    steps = N_SAVES * per_save
    diag_fn = _hist if diag else None
    ce = cg = c
    before = dict(sg.ROUTES)
    for i in range(3):
        n0 = _launches()
        ce, oe = _eager(ce, s, cfg, step, N_SAVES, diag_fn)
        eager = _launches_since(n0)
        n1 = _launches()
        if i < 2:
            cg, og = run(cg, s, cfg, N_SAVES, diag_fn=diag_fn)
        else:
            (cg, og), records = _kernel_records(
                lambda: run(cg, s, cfg, N_SAVES, diag_fn=diag_fn), tmp_path)
        graph = _launches_since(n1)
        _require_same_bits(_answers(cg, og), _answers(ce, oe))
        assert eager["march"] == steps
        if i == 0:
            assert graph == eager
        elif i == 1:
            assert {k: n * steps for k, n in graph.items()} == eager
        else:
            assert not any(graph.values())
            assert records == {k: eager[k] for k in KERNELS}
    assert int(cg.overflow) == 0
    assert _routes_since(before) == {
        "graph": 2 * N_SAVES * per_save, "captures": 1,
        "eager": 4 * N_SAVES * per_save}
    assert len(sg._CACHE) == 1


@pytest.mark.card
@pytest.mark.parametrize("name", list(MODELS))
def test_kept_carries_restart_and_rerun(card, name):
    """A chunk re-run from a kept start, a restart from an older carry and
    a carry changed in place after its return all give the eager loop's
    bits; what a chunk returned is unchanged by the chunks after it, and
    no chunk modifies its input."""
    cfg, s, c0, run, step = _model(name, SMALL, card, torch.float32)
    c1, _ = run(c0, s, cfg, N_SAVES)                 # bootstrap, eager
    c2, o2 = run(c1, s, cfg, N_SAVES)                # capture and replay
    kept2 = _clones(_answers(c2, o2))
    kept1 = _clones(_answers(c1, ()))
    c3, o3 = run(c2, s, cfg, N_SAVES)                # the last chunk's carry
    c3b, o3b = run(c2, s, cfg, N_SAVES)              # re-run from c2
    _require_same_bits(_answers(c3b, o3b), _answers(c3, o3))
    c4, o4 = run(c3, s, cfg, N_SAVES)                # from an older carry
    c4b, o4b = run(c3b, s, cfg, N_SAVES)
    _require_same_bits(_answers(c4b, o4b), _answers(c4, o4))
    c2r, o2r = run(c1, s, cfg, N_SAVES)              # restart from c1
    _require_same_bits(_answers(c2r, o2r), kept2)
    _require_same_bits(_answers(c2, o2), kept2)
    _require_same_bits(_answers(c1, ()), kept1)
    ce, oe = _eager(c3, s, cfg, step, N_SAVES)
    _require_same_bits(_answers(c4, o4), _answers(ce, oe))
    # a carry changed in place after its return
    c5, _ = run(c4, s, cfg, N_SAVES)
    c5.packet_k.mul_(1.001)
    cg, og = run(c5, s, cfg, N_SAVES)
    ce, oe = _eager(c5, s, cfg, step, N_SAVES)
    _require_same_bits(_answers(cg, og), _answers(ce, oe))


@pytest.mark.card
def test_a_new_setup_captures_anew_and_the_cache_stays_bounded(card):
    """Setups with another dt (a CFL recheck makes such) each
    capture their own graph; one is kept, the one before it freed, and
    going back to an older setup captures again."""
    runs = []
    for cfl in (0.25, 0.2, 0.15):
        cfg, s, c, run, step = _model("two_layer", SMALL, card,
                                      torch.float32, CFL_fraction=cfl)
        c, _ = run(c, s, cfg, 1)
        runs.append((cfg, s, c, run, step))
    assert len({s.dt for _, s, *_ in runs}) == 3
    for cfg, s, c, run, step in runs + runs[:1]:
        before = dict(sg.ROUTES)
        cg, og = run(c, s, cfg, N_SAVES)
        assert _routes_since(before)["captures"] == 1
        assert len(sg._CACHE) == 1
        ce, oe = _eager(c, s, cfg, step, N_SAVES)
        _require_same_bits(_answers(cg, og), _answers(ce, oe))
    cfg, s, c, run, _ = runs[0]
    before = dict(sg.ROUTES)
    run(c, s, cfg, N_SAVES)
    assert _routes_since(before)["captures"] == 0


@pytest.mark.card
def test_a_replay_is_one_span(card):
    """With spans on, a chunk by the graph route records one swr.graph a
    save and none of the step's own spans."""
    cfg, s, c, run, _ = _model("two_layer", SMALL, card, torch.float32)
    c, _ = run(c, s, cfg, 1)
    c, _ = run(c, s, cfg, 1)                 # the capture's pass
    with profiling.spans() as table:
        run(c, s, cfg, N_SAVES)
    assert {n: row["calls"] for n, row in table.items()} == {
        "swr.graph": N_SAVES}
