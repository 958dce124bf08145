"""What the metric readers (``metrics/<metric>.py``) share: the kind of a run's
window, the profiler session's device time by kernel family, and the work the
roofline shares are taken over (the benchmark's own arithmetic over the frozen
``work()`` copies, never the port's).

A roofline share is the least time the work needs at the card's peaks over the
device time its kernels took, in percent. Its kernels are attributed by name with
the frozen family classifier.
"""

from __future__ import annotations

import statistics
from typing import List, Optional, Tuple

from .frozen import work
from .frozen.families import family
from .frozen.peaks import PEAK_BF16_FLOP_S
from .inputs import stage_geometry
from .reference.network import PLANES, trainable

B1 = ("B1 eval_fused",)
LOSS_CORE = ("B2 loss_fwd", "B3 loss_bwd")
CONV3X3 = ("B4 conv3x3 fwd/dx", "B5 conv3x3 wgrad")


def kind(rec: dict) -> str:
    """"train" or "eval": what the cell's window drove."""
    return rec["mix"]["driver"]


def session(rec: dict, want: str) -> Optional[dict]:
    """The profiler session of a traced run whose window is of kind ``want``."""
    if kind(rec) != want or "session" not in rec:
        return None
    return rec["session"]


def family_ms(s: dict, families) -> Tuple[float, int]:
    """(device ms, launches) of the session's operations in ``families``."""
    ms, n = 0.0, 0
    for name, _, dur in s["ops"]:
        if family(name) in families:
            ms += dur / 1e3
            n += 1
    return ms, n


def mean(values: List[float]) -> Optional[float]:
    return statistics.fmean(values) if values else None


def conv3x3_calls(cfg: dict, mix: dict) -> List[Tuple[str, int, int, int, int, int]]:
    """The B4 / B5 calls of one train step or one eval call, (op, batch, H, W, C, O):
    every bottleneck's 3x3 conv forward (the SimT teacher's too; each eval scale's),
    its input gradient where that input depends on a trained tensor, its weight
    gradient where the weight trains."""
    m = cfg["model"]
    layers, b = m["layers"], mix["batch"]
    calls = []
    if mix["driver"] == "eval":
        for hw in mix["scales"]:
            for (h, w), planes, blocks in zip(stage_geometry(hw, layers), PLANES, layers):
                calls += [("fwd", b, h, w, planes, planes)] * blocks
        return calls
    stage = cfg["stage"]
    geo = stage_geometry(mix["hw"], layers)
    forwards = 2 if stage == "simt" else 1  # the SimT teacher runs the trunk too
    grad_above = trainable("conv1.weight", stage=stage) != "frozen"
    for si, ((h, w), planes, blocks) in enumerate(zip(geo, PLANES, layers)):
        for bi in range(blocks):
            pre = f"layer{si + 1}.{bi}"
            grad_above = (grad_above
                          or trainable(f"{pre}.conv1.weight", stage=stage) != "frozen")
            calls += [("fwd", b, h, w, planes, planes)] * forwards
            if grad_above:
                calls.append(("dx", b, h, w, planes, planes))
            if trainable(f"{pre}.conv2.weight", stage=stage) != "frozen":
                calls.append(("wgrad", b, h, w, planes, planes))
    return calls


def whole_ms(s: dict, families) -> Optional[float]:
    """The session's device ms in ``families``, unscaled; None when they ran nothing, or
    when their recorded launches are no whole multiple of the session's steps (calls),
    as when the profiler dropped a record."""
    ms, n = family_ms(s, families)
    return ms if n and ms > 0 and n % s["calls"] == 0 else None


def launches(rec: dict, want: str, families) -> Optional[float]:
    """The launches a step (call) in ``families``, read beside their roofline: a change
    of the program's launch structure shows here, not in the roofline."""
    s = session(rec, want)
    if s is None:
        return None
    n = family_ms(s, families)[1]
    return n / s["calls"] if n else None


def conv3x3_roofline(rec: dict, want: str) -> Optional[float]:
    """The bound of a step's (call's) B4 + B5 work over their recorded device ms, in
    percent: however many launches carry the work, their time is summed."""
    s = session(rec, want)
    if s is None:
        return None
    ms = whole_ms(s, CONV3X3)
    if ms is None:
        return None
    calls = conv3x3_calls(rec["config"], rec["mix"])
    bound_s = sum(work.conv3x3_bound_s(*work.conv3x3_work(*c[1:], 2, c[0])) for c in calls)
    return 100.0 * bound_s * 1e3 * s["calls"] / ms


def logits_hw(hw, layers) -> Tuple[int, int]:
    """The stride-8 logits' (H, W) of an input of ``hw``."""
    return stage_geometry(hw, layers)[-1]


def idle_share(rec: dict, want: str) -> Optional[float]:
    from .trace import busy_us

    s = session(rec, want)
    if s is None or s["window_us"] <= 0:
        return None
    return 100.0 * (1.0 - busy_us(s) / s["window_us"])


def mfu(rec: dict, want: str) -> Optional[float]:
    """The cell's counted FLOPs an image times the window's images, over its wall
    seconds and the bf16 peak, in percent."""
    flops = (rec["config"].get("flops_per_image") or {}).get(want)
    win = rec["window"]
    if kind(rec) != want or not flops or win.get("peak_bytes") is None:
        return None
    return 100.0 * flops * win["images"] / win["wall_s"] / PEAK_BF16_FLOP_S


def on_card(rec: dict) -> bool:
    """Whether the window ran on a card: a CPU run gives no device metric."""
    return rec["window"].get("peak_bytes") is not None


# The quantities of a training window, read alike in each stage's cells; each stage
# names its own metrics (``<metric>.simt``, ``<metric>.warmup``), so that each has a
# bound of its own.

def train_img_s(rec: dict) -> Optional[float]:
    """Images trained over the window: every image of every step, over the wall seconds
    from the first step's call to the synchronize after the last."""
    if kind(rec) != "train" or not on_card(rec):
        return None
    win = rec["window"]
    return win["images"] / win["wall_s"]


def train_step_ms_p90(rec: dict) -> Optional[float]:
    """The 90th percentile of the time of every step of the window, each the gap between
    CUDA events recorded on the stream at its boundaries (no synchronize between steps,
    so a stall counts)."""
    ms = rec["window"].get("step_ms") if kind(rec) == "train" else None
    if not ms or len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=10, method="inclusive")[8]


def host_ms_per_step(rec: dict) -> Optional[float]:
    """Host ms from a train step's call to its return (the enqueue; nothing waits for
    the card), the mean over the untraced window."""
    if kind(rec) != "train" or not on_card(rec):
        return None
    return mean(rec["window"]["host_ms"])


def launches_per_step(rec: dict) -> Optional[float]:
    """Device operations (kernels and memory operations) a train step in the profiler
    session."""
    s = session(rec, "train")
    return None if s is None else len(s["ops"]) / s["calls"]


def _family_ms_per_step(rec: dict, families) -> Optional[float]:
    s = session(rec, "train")
    if s is None:
        return None
    ms, n = family_ms(s, families)
    return ms / s["calls"] if n else None


def batchnorm_ms(rec: dict) -> Optional[float]:
    """Device ms a train step of the BatchNorm family of kernels (the frozen
    classifier), in the profiler session."""
    return _family_ms_per_step(rec, ("batch norm",))


def cast_copy_ms(rec: dict) -> Optional[float]:
    """Device ms a train step of the copy / memset family (autocast's casts,
    device-to-device copies, fills), in the profiler session."""
    return _family_ms_per_step(rec, ("copy / memset",))


def optimizer_ms(rec: dict) -> Optional[float]:
    """Device ms a step of the step's span "optimizer" (SGD, and the SimT step's Adam on
    T1 / T2), the program's own spans."""
    return rec.get("spans", {}).get("optimizer")


def train_idle_share(rec: dict) -> Optional[float]:
    """1 - (the union of the device's busy intervals) / (the profiler session's window),
    in percent, over a few train steps."""
    return idle_share(rec, "train")


def train_mfu(rec: dict) -> Optional[float]:
    """The configuration's counted FLOPs a trained image times the window's images, over
    the untraced window's wall seconds and the bf16 peak (989 TFLOP/s, SXM, 700 W), in
    percent."""
    return mfu(rec, "train")


def train_conv3x3_roofline(rec: dict) -> Optional[float]:
    """The bound of a train step's B4 / B5 calls (frozen work(), bf16 peak or HBM rate)
    over their recorded device ms, in percent."""
    return conv3x3_roofline(rec, "train")


def train_conv3x3_launches(rec: dict) -> Optional[float]:
    """A train step's B4 / B5 launches, read beside the conv3x3 roofline."""
    return launches(rec, "train", CONV3X3)
