"""The benchmark's closed-form FLOP count against the port's counter
(``simt_tpu_torch/tools/flops.py``: a float32 CPU twin under ``FlopCounterMode``)."""

import pytest

from benchmark import flops, harness

SIMT = "deeplabv2_multi_r101_simt"


def _cfg(name, layers):
    cfg = harness.load_json(f"{harness.HERE}/configs/{name}.json")
    cfg["model"]["layers"] = list(layers)
    return cfg


def test_the_models_convolutions_equal_the_port_count_at_a_small_geometry():
    from simt_tpu_torch.tools import flops as port

    layers, hw = (1, 1, 1, 1), (64, 128)
    m = _cfg(SIMT, layers)["model"]
    student = flops.convs(m, hw, True, "simt")
    theirs = {w: port.step_work(w, layers=layers, hw=hw)["flops"]
              for w in ("fwd", "teacher", "fwdbwd", "step")}
    assert flops.forward_flops(student) == theirs["fwd"]
    assert flops.forward_flops(flops.convs(m, hw, False, "simt")) == theirs["teacher"]
    assert (flops.forward_flops(student) + flops.backward_flops(student, "simt")
            == theirs["fwdbwd"])
    # The step adds the losses' dense interpolation matmuls and the W loop, which the
    # closed form leaves out: under 1% at this size.
    mine = flops.per_image(_cfg(SIMT, layers), hw)["train"]
    assert 0.99 * theirs["step"] < mine < theirs["step"]


@pytest.mark.parametrize("name", [c["name"] for c in harness.spec()["configs"]])
def test_the_stored_counts_are_the_closed_form_at_the_cells_geometry(name):
    cfg = harness.load_json(f"{harness.HERE}/configs/{name}.json")
    train = harness.load_json(f"{harness.HERE}/mixes/train_b16.json")
    ev = harness.load_json(f"{harness.HERE}/mixes/eval_b8.json")
    scales = ev["scales"] if cfg["stage"] == "simt" else None
    assert cfg["flops_per_image"] == flops.per_image(cfg, train["hw"], scales)
