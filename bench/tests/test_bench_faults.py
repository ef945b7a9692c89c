"""The check that decides ``correct`` fails what it must, on the CPU at the
smoke sizes: a run with the timed path broken underneath (the program's
serving entry points wrapped) comes out not correct, once for each fault
a cell can have; the fp8 control departs from the reference where the
fp32 program does not, and (on the card, at each cell's size, on three
seeds) put in the program's place comes out not correct."""
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.harness import spec  # noqa: E402
from bench.harness.run_cell import run  # noqa: E402

SEED = 2**31 + 4242
PREFILL = ["internlm2-1.8b.prefill-conv-8k"]
DECODE = ["internlm2-1.8b.decode-32k"]


def _run(workload, control=None):
    """A smoke run: 0.3 s of prefill calls; the decode cell's window is
    given time to run its smoke sessions to their end (89 steps), so that a
    broken state has as many steps to show in as the sessions hold."""
    decode = spec.load_cell(workload).traffic["mode"] == "decode"
    return run(workload, SEED, 30.0 if decode else 0.3, False, device="cpu",
               smoke=True, control=control)


def _prefill_fault(monkeypatch, fault):
    from repro_torch.serve import decode as serve_decode
    orig = serve_decode.prefill_step

    def broken(params, cfg, inputs):
        toks = inputs["tokens"]
        B = toks.shape[0]
        if fault == "half_batch" and B > 1:
            half = orig(params, cfg, {"tokens": toks[:B // 2]})
            return torch.cat([half, half])[:B]
        lg = orig(params, cfg, inputs)
        if fault == "token_altered":
            lg = lg.clone()
            lg[0] = lg[0].roll(1)
        return lg
    monkeypatch.setattr(serve_decode, "prefill_step", broken)


def _decode_fault(monkeypatch, fault):
    from repro_torch.serve import engine as serve_engine
    orig = serve_engine.make_decode_step
    calls = {"n": 0}

    def make(cfg, window=0):
        step = orig(cfg, window)

        def broken(params, token, cache, pos):
            calls["n"] += 1
            if fault == "state_unchanged":
                copy = type(cache)(*(t.clone() for t in cache))
                nxt, _ = step(params, token, copy, pos)
                return nxt, cache
            nxt, cache = step(params, token, cache, pos)
            nxt = nxt.clone()
            B = nxt.shape[0]
            if fault == "half_batch":
                nxt[B // 2:] = nxt[:B - B // 2]
            elif fault == "token_altered" and calls["n"] == 5:
                nxt[0] = (nxt[0] + 1) % cfg.vocab_size
            return nxt, cache
        return broken
    monkeypatch.setattr(serve_engine, "make_decode_step", make)


CASES = ([(w, f) for w in PREFILL for f in ("half_batch", "token_altered")]
         + [(w, f) for w in DECODE
            for f in ("state_unchanged", "half_batch", "token_altered")])


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    mode = spec.load_cell(workload).traffic["mode"]
    (_prefill_fault if mode == "prefill" else _decode_fault)(monkeypatch,
                                                             fault)
    res, _ = _run(workload)
    assert res["correct"] is False
    assert res["checks"]["gap_max"]["value"] \
        > res["checks"]["gap_max"]["limit"]


def test_the_fp8_control_departs_where_the_fp32_program_does_not():
    res, _ = _run(DECODE[0])
    assert res["correct"] is True
    assert res["checks"]["gap_max"]["value"] == 0.0     # fp32 at smoke size
    ctl, info = _run(DECODE[0], control="fp8")
    assert info["control"] == "fp8"
    assert ctl["checks"]["gap_max"]["value"] > 0.0
    assert ctl["checks"]["missing"]["value"] == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", PREFILL + DECODE)
@pytest.mark.parametrize("seed", [SEED, 2**31 + 90001, 5_000_000_017])
def test_the_fp8_control_fails_each_cells_limit_on_the_card(card, workload,
                                                            seed):
    """The control at the cell's own size, as the limits were set: a run
    of the cell in which the fp8 reference's picks take the served
    tokens' place comes out not correct."""
    import subprocess
    r = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        workload, "--seed", str(seed), "--seconds", "20",
                        "--trace", "0", "--control", "fp8"],
                       capture_output=True, text=True, cwd=ROOT, timeout=360)
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    print(workload, seed, res["checks"])
    assert res["correct"] is False
    assert res["checks"]["gap_max"]["value"] \
        > res["checks"]["gap_max"]["limit"]
