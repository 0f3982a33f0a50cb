"""The comparison that decides ``correct``, driven end to end on the CPU
at a small size: a run of the harness (``run.run_cell``, the look for a
chip skipped) with the timed path broken underneath comes out not
correct, once for each fault a one-chip training cell can have (a step
that returns its state unchanged; half of each batch left out, the mean
taken over the rest); and the control (the reference in fp8, put in the
program's place) fails the cell's own limits. On the card, each cell
runs whole and comes out correct.

Each cell's scenario runs in a subprocess of its own, so the worker
group it joins is its own."""
import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CELLS = ("resnet50.dp_b256", "mixtral-8x7b.l1.dp_4x1024")
# the cells' families at a size a test run holds
SMALL = {
    "resnet50.dp_b256": (
        {"conv_stages": [1, 1], "conv_width": 16, "num_classes": 10,
         "image_size": 32},
        {"batch": 4, "image_size": 32, "num_classes": 10,
         "pool_batches": 3, "warmup_steps": 3}),
    "mixtral-8x7b.l1.dp_4x1024": (
        {"d_model": 128, "n_heads": 4, "n_kv_heads": 2, "head_dim": 32,
         "d_ff": 256, "vocab_size": 512, "n_experts": 4,
         "sliding_window": 64},
        {"batch": 4, "seq_len": 64, "pool_batches": 3, "warmup_steps": 3}),
}
SEED = 2 ** 31 + 101


def _state_tensors(tree, out):
    for v in tree.values():
        if isinstance(v, dict):
            _state_tensors(v, out)
        elif hasattr(v, "copy_"):
            out.append(v)
    return out


def unchanged(prog, step):
    """A step that returns its state as it found it."""
    def run(state, batch):
        held = _state_tensors(state, [])
        saved = [t.clone() for t in held]
        count = state["opt"]["step"]
        state, metrics = step(state, batch)
        for t, s in zip(held, saved):
            t.copy_(s)
        state["opt"]["step"] = count
        return state, metrics
    return run


def half(prog, step):
    """A step that leaves out half of each batch: the mean is taken over
    the rest."""
    def run(state, batch):
        cut = {k: v[:v.shape[0] // 2] if getattr(v, "dim", lambda: 0)()
               else v for k, v in batch.items()}
        return step(state, cut)
    return run


def scenario(cell: str) -> dict:
    sys.path.insert(0, BENCH)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import control
    import run as bench_run
    from harness import judge, manifest
    from traffic.generate import load as load_mix
    man = manifest.load()
    entry = manifest.cell(man, cell)
    cfg = manifest.config(man, entry)
    model, traffic = SMALL[cell]
    cfg["model"].update(model)
    mix = dict(load_mix(entry["traffic"]), **traffic)

    def once(wrap=None, limits=None):
        res, table = bench_run.run_cell(man, cell, SEED, 0.2, False, "cpu",
                                        wrap_step=wrap, cfg=cfg, mix=mix,
                                        limits=limits)
        return res["correct"], {k: v for k, (v, _, _) in table.items()}

    cell_limits = judge.load_limits(cell)
    _, sound = once()
    # the cell's limits are set at its own size; here each is widened to
    # four times what the sound program reads at this size
    limits = {k: max(lim, 4 * sound[k]) for k, lim in cell_limits.items()}
    out = {"sound": once(limits=limits)[0]}
    for name, wrap in (("unchanged", unchanged), ("half", half)):
        out[name] = once(wrap, limits)[0]
    line = next(control.readings(cell, [SEED], 1, "cpu", cfg, mix))
    ctrl = {k: (line["control"][k], 0) for k in line["control"]}
    out["control"] = judge.verdict(ctrl, cell_limits)
    return out


@pytest.fixture(scope="module", params=CELLS)
def outcome(request):
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          request.param], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_sound_run_is_correct(outcome):
    assert outcome["sound"] is True


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_broken_step_is_not_correct(outcome, fault):
    assert outcome[fault] is False


def test_control_fails_the_limits(outcome):
    assert outcome["control"] is False


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    res = subprocess.run([sys.executable, "bench/run.py", "--workload", cell,
                          "--seed", str(SEED), "--seconds", "3",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=900, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["correct"]


if __name__ == "__main__":
    print(json.dumps(scenario(sys.argv[1])))
