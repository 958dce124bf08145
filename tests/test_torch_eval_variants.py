"""The eval head's variants (simt_tpu_torch/tools/eval_variants.py, the counterpart of
experiments/wide_aspp_eval_fault/repro.py) on the CPU at the smoke geometry (layers
(1,1,1,1), float32, 64x128 + 80x160 -> 128x256; B1 takes its plain version on CPU
tensors): the ``fused`` and ``split`` histograms equal bit for bit and the ``unfused``
one with equal totals and an L1 of at most 2e-5 H W against them; each variant's JSON
line; the checks failing on histograms that break either rule; the CLI's three lines
and its checks."""

import json

import pytest
import torch

from simt_tpu_torch.tools import eval_variants as ev


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One thread: the tests' tensors are small, and several threads per process under
    the suite's parallel workers only wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_three_variants_agree_on_the_cpu():
    lines = []
    out = ev.run(device="cpu", calls=1, geometry=ev.SMOKE, print_fn=lines.append)
    h, w = ev.SMOKE[2]
    hists = out["hists"]
    assert torch.equal(hists["fused"], hists["split"])
    fused, unfused = hists["fused"].long(), hists["unfused"].long()
    assert int(fused.sum()) == int(unfused.sum()) == h * w
    assert int((fused - unfused).abs().sum()) <= 2e-5 * h * w
    assert out["checks"]["ok"] and out["checks"]["fused_split_equal"]
    recs = [json.loads(s) for s in lines]
    assert [r["variant"] for r in recs[:3]] == list(ev.VARIANTS)
    assert all(r["device"] == "cpu" and r["img_per_sec"] > 0 and r["b1_launches"] == 0
               for r in recs[:3])  # the plain version on the CPU: no launch
    assert recs[3] == {"checks": out["checks"]}


def test_checks_fail_on_histograms_that_disagree():
    base = torch.zeros((ev.C, ev.C), dtype=torch.int32)
    base[0, 0] = 100
    moved = base.clone()
    moved[0, 0], moved[0, 1] = 99, 1
    assert ev.check({"fused": base, "split": base, "unfused": moved}, (300, 400))["ok"]
    assert not ev.check({"fused": base, "split": moved}, (10, 10))["ok"]
    assert not ev.check({"fused": base, "unfused": moved}, (100, 100))["ok"]  # L1 2 > 0.2
    lost = base.clone()
    lost[0, 0] = 99
    assert not ev.check({"fused": base, "unfused": lost}, (10, 10))["ok"]  # totals


def test_cli_runs_the_three_variants_and_holds_their_histograms(capsys):
    out = ev.main(["--smoke", "--device", "cpu"])
    assert out["checks"]["ok"] and list(out["records"]) == list(ev.VARIANTS)
    assert all(r["calls"] == 20 for r in out["records"].values())
    assert len(capsys.readouterr().out.splitlines()) == len(ev.VARIANTS) + 1
