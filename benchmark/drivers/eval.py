"""The evaluation window: a closed loop of the port's two-scale ``predict_hist``
(``make_eval_fn(model, C, "simt", out_hw)``) over a pool of distinct batches resident on
the device, each call adding its batch into one running histogram on the device.

Each call's answer is its batch's histogram. After each call the running histogram is
copied on the device (one small copy), so that every answer of the window is read
once it has closed: the difference of two copies. Every answer is compared with the
reference's histogram of its batch; a call whose answer does not count each of its
batch's labelled pixels once has failed. One call among the window's first, drawn
from the seed, also keeps its logits (a forward hook that copies them on the device):
they are held to the reference's, and its answer to the reference's histogram of
those same logits (B1's own check).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from .. import compare, inputs, program, trace
from ..reference.training import ieee_fp32

WARM_CALLS = 2


class Cell:
    def __init__(self, run):
        self.run = run
        cfg, mix, dev, seed = run.config, run.mix, run.device, run.seed
        model = cfg["model"]
        self.c = model["num_classes"]
        t_port = time.perf_counter()
        program.load()
        t0 = time.perf_counter()
        self.pool = inputs.eval_pool(seed, mix, self.c, dev)
        self.counted = [inputs.counted(b["gt"], self.c) for b in self.pool]
        t_inputs = time.perf_counter()
        weights = inputs.model_weights(seed, "student", model, dev, model["openset"])
        self.model, self.predict_hist = program.eval_fn(cfg, weights, mix["out_hw"], dev)
        self.sample = inputs.sub_seed(seed, "eval_sample") % len(self.pool)
        self.own: List[torch.Tensor] = []
        del weights
        t1 = time.perf_counter()
        scratch = torch.zeros((self.c, self.c), dtype=torch.int32, device=dev)
        for i in range(WARM_CALLS):
            self._call(i, scratch)
        scratch.cpu()
        self.setup_parts = {"port_imports": t0 - t_port, "inputs": t_inputs - t0,
                            "program": t1 - t_inputs,
                            "first_steps": time.perf_counter() - t1}
        self.answers: List[torch.Tensor] = []

    def _call(self, i: int, out: torch.Tensor) -> None:
        b = self.pool[i % len(self.pool)]
        self.predict_hist(*b["scales"], b["gt"], out=out)

    def _call_keeping_logits(self, i: int, out: torch.Tensor) -> None:
        c = self.c
        hook = self.model.register_forward_hook(
            lambda mod, args, y: self.own.append(y[1][:, :c].detach().float().clone()))
        try:
            self._call(i, out)
        finally:
            hook.remove()

    def window(self, seconds: float) -> dict:
        """Calls back to back until ``seconds`` of host time have passed, then a read of
        the histogram: the calls, the images, the wall seconds, each call's host ms,
        the peak memory; every call's answer is kept for ``check``."""
        dev = self.run.device
        on_card = dev.type == "cuda"
        hist = torch.zeros((self.c, self.c), dtype=torch.int32, device=dev)
        snaps, host_ms = [], []
        if on_card:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or len(snaps) <= self.sample:
            h0 = time.perf_counter()
            if len(snaps) == self.sample:
                self._call_keeping_logits(len(snaps), hist)
            else:
                self._call(len(snaps), hist)
            host_ms.append((time.perf_counter() - h0) * 1e3)
            snaps.append(hist.clone())
        total = hist.cpu()
        wall = time.perf_counter() - t0
        self.own = [x.cpu() for x in self.own]
        prev = torch.zeros_like(total)
        for s in snaps:
            s = s.cpu()
            self.answers.append(s - prev)
            prev = s
        if not torch.equal(prev, total):
            raise RuntimeError("the running histogram moved after the window closed")
        failed = sum(int(a.sum()) != self.counted[i % len(self.pool)]
                     for i, a in enumerate(self.answers))
        return {"calls": len(snaps), "images": len(snaps) * self.run.mix["batch"],
                "failed": failed, "wall_s": wall, "host_ms": host_ms,
                "peak_bytes": torch.cuda.max_memory_allocated(dev) if on_card else None}

    def spans(self) -> Dict[str, float]:
        return {}  # the eval path records no spans of its own

    def session(self, host: bool = False) -> dict:
        scratch = torch.zeros((self.c, self.c), dtype=torch.int32, device=self.run.device)
        n = self.run.mix["trace_calls"]
        rec = trace.session(lambda i: self._call(i, scratch), n, host)
        rec["counted"] = [self.counted[i % len(self.pool)] for i in range(n)]
        return rec

    def release(self) -> None:
        del self.predict_hist, self.model
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """``hist_mismatch`` of every answer; ``err_eval_logits`` and
        ``hist_core_mismatch`` of the sampled call."""
        k = self.sample
        ref = reference(self.run, self.pool, k)
        core = reference_module(self.run).hist_from_logits(
            self.own, self.pool[k]["gt"], self.run.mix["out_hw"]).cpu()
        return {**compare.eval_numbers(self.answers, ref["hists"], self.counted),
                "err_eval_logits": compare.logits_err(self.own, ref["logits"]),
                "hist_core_mismatch": compare.hist_share(self.answers[k], core,
                                                         self.counted[k])}


def reference_module(run):
    from .. import harness

    return harness.reference_module(run.workload["config"])


def reference(run, pool: List[dict], sample: int, precision: str = "fp32") -> dict:
    """The reference's histogram of each pool batch (``hists``) and the logits of the
    batch ``sample`` (``logits``), from the same weights (made again from the seed)."""
    cfg, dev = run.config, run.device
    weights = inputs.model_weights(run.seed, "student", cfg["model"], dev,
                                   cfg["model"]["openset"])
    ref = reference_module(run)
    out_hw = run.mix["out_hw"]
    with ieee_fp32():
        logits = [ref.eval_logits(cfg, weights, b, precision=precision) for b in pool]
    return {"hists": [ref.hist_from_logits(x, b["gt"], out_hw).cpu()
                      for x, b in zip(logits, pool)],
            "logits": [x.cpu() for x in logits[sample]]}
