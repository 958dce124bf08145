"""The training window: a closed loop of the port's train step (SimT or warmup, by the
configuration's ``stage``) over a pool of distinct batches resident on the device,
dispatched ahead with no synchronize between steps.

Set-up builds the one state the window uses and drives it through the mix's
``warm_steps`` first steps, through the window's own call, on the pool's first batches
(rows that all differ). They warm every shape up, and the first of them gives the
program's readings for the comparison: its loss and loss terms, each leaf's gradient
as the optimizer got it (worked out from its state after the step), each leaf's
change, and the step's activations: the stem's, each stage's and both heads' logits
(forward hooks on the student, and the SimT teacher's logits). The window then goes on
from that state. After the window and the program's state are gone, the reference
follows the first step from the same weights and batch. (Later steps are not
compared: from the second step on, the SimT anchor's argmax over every pixel and the
warmup's rising loss make two float32 programs part by more than the precision does;
``PERF.md``.)
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from .. import compare, inputs, program, trace
from ..reference import network
from ..reference.training import ieee_fp32

SPAN_STEPS = 3  # steps with the program's spans on, after the window


class Cell:
    """The program's state and step, the pool, and what set-up read."""

    def __init__(self, run):
        self.run = run
        cfg, mix, dev, seed = run.config, run.mix, run.device, run.seed
        model = cfg["model"]
        self.stage = cfg["stage"]
        t_port = time.perf_counter()
        program.load()
        t0 = time.perf_counter()
        self.pool = inputs.train_pool(seed, mix, model["num_classes"], dev)
        t_inputs = time.perf_counter()
        student = inputs.model_weights(seed, "student", model, dev, model["openset"])
        if self.stage == "simt":
            teacher = inputs.model_weights(seed, "teacher", model, dev, False)
            self.state, self.step = program.simt(cfg, student, teacher,
                                                 inputs.ntm_params(seed, model, dev), dev)
        elif self.stage == "warmup":
            self.state, self.step = program.warmup(cfg, student, dev)
        else:
            raise ValueError(f"unknown stage {self.stage!r}")
        del student
        t1 = time.perf_counter()
        self.readings = self._first_steps(mix["warm_steps"])
        self.setup_parts = {"port_imports": t0 - t_port, "inputs": t_inputs - t0,
                            "program": t1 - t_inputs,
                            "first_steps": time.perf_counter() - t1}

    def _leaves(self) -> Dict[str, torch.Tensor]:
        named = dict(self.state.model.named_parameters())
        if self.stage == "simt":
            named.update({k: getattr(self.state, k).param
                          for k in ("t1", "t2", "w1", "w2")})
        return named

    def loss(self, metrics: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The step's loss: SimT's ``loss``; warmup's ``l2 + lambda_seg * l1``."""
        if self.stage == "simt":
            return metrics["loss"]
        lam = self.run.config["simt"]["lambda_seg"]
        return metrics["loss_seg2"] + lam * metrics["loss_seg1"]

    def _first_grads(self, start: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each leaf's gradient of the first step as its optimizer got it, from the
        state after that step: SGD's momentum buffer is ``grad + weight_decay * p0``,
        Adam's first moment ``(1 - beta1) * grad``. W1 / W2 took several Adam steps
        inside the step, so their first gradient is not read."""
        wd = self.run.config["optim"]["weight_decay"]
        out = {}
        opt_state = self.state.model_opt.state
        for name, p in self.state.model.named_parameters():
            buf = opt_state.get(p, {}).get("momentum_buffer")
            if buf is not None:
                out[name] = buf - wd * start[name]
        if self.stage == "simt":
            for k in ("t1", "t2"):
                n = getattr(self.state, k)
                beta1 = n.opt.param_groups[0]["betas"][0]
                out[k] = n.opt.state[n.param]["exp_avg"] / (1.0 - beta1)
        return out

    def _first_steps(self, warm: int) -> dict:
        """The warm-up steps; the readings of the first."""
        named = self._leaves()
        start = {k: p.detach().clone() for k, p in named.items()}
        taps, own = {}, {}
        hooks = self._tap_hooks(taps, own)
        m = self.step(self.state, self.pool[0])
        for h in hooks:
            h.remove()
        parts = {"loss": float(self.loss(m)),
                 **{k: float(v) for k, v in m.items() if k != "lr"}}
        grads = {k: float(g.double().norm()) for k, g in self._first_grads(start).items()}
        change = {k: float((p.detach().double() - start[k].double()).norm())
                  for k, p in named.items()}
        del start
        for i in range(1, warm):
            self.step(self.state, self.pool[i % len(self.pool)])
        return {"loss": parts["loss"], "parts": parts, "grad": grads, "change": change,
                "taps": taps, "own": own}

    def _tap_hooks(self, taps: dict, own: dict) -> list:
        """Forward hooks that keep the student's stem, stage and logit outputs (and the
        SimT teacher's head-2 logits) of the next step in ``taps`` (``network.tap``),
        and its logits whole in ``own``."""
        model = self.state.model

        def keep(name):
            return lambda mod, args, out: network.tap(taps, name, out)

        def logits(mod, args, out):
            network.tap(taps, "logits1", out[0])
            network.tap(taps, "logits2", out[1])
            own["x1"], own["x2"] = (y.detach().float().cpu() for y in out)

        def teacher(mod, args, out):
            network.tap(taps, "teacher", out[1])
            own["teacher"] = out[1].detach().float().cpu()

        hooks = [model.maxpool.register_forward_hook(keep("stem")),
                 model.register_forward_hook(logits)]
        hooks += [getattr(model, f"layer{i}").register_forward_hook(keep(f"layer{i}"))
                  for i in range(1, 5)]
        if self.stage == "simt":
            hooks.append(self.state.teacher.register_forward_hook(teacher))
        return hooks

    def window(self, seconds: float) -> dict:
        """Steps back to back until ``seconds`` of host time have passed, then a
        synchronize: the steps, their losses' failures, the wall seconds, each step's
        device-paced time (CUDA events at the step boundaries) and host ms (the call's
        return), the peak memory."""
        dev = self.run.device
        on_card = dev.type == "cuda"
        k0 = self.run.mix["warm_steps"]
        losses, host_ms, events = [], [], []
        _sync(dev)
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
            events.append(_event())
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or not losses:
            h0 = time.perf_counter()
            m = self.step(self.state, self.pool[(k0 + len(losses)) % len(self.pool)])
            host_ms.append((time.perf_counter() - h0) * 1e3)
            losses.append(self.loss(m).detach())
            if on_card:
                events.append(_event())
        _sync(dev)
        wall = time.perf_counter() - t0
        step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        return {"steps": len(losses), "images": len(losses) * self.run.mix["batch"],
                "failed": failed, "wall_s": wall, "step_ms": step_ms, "host_ms": host_ms,
                "peak_bytes": torch.cuda.max_memory_allocated(dev) if on_card else None}

    def spans(self) -> Dict[str, float]:
        """Device ms a step of each of the step's spans, over SPAN_STEPS steps."""
        self.step.spans = []
        for i in range(SPAN_STEPS):
            self.step(self.state, self.pool[i % len(self.pool)])
        torch.cuda.synchronize()
        out: Dict[str, float] = {}
        for name, a, b in self.step.spans:
            out[name] = out.get(name, 0.0) + a.elapsed_time(b) / SPAN_STEPS
        self.step.spans = None
        return out

    def session(self, host: bool = False) -> dict:
        """A profiler session over the mix's ``trace_steps`` steps (``trace.session``),
        with the labelled head-pixels of each step's batch (the loss core's work)."""
        n = self.run.mix["trace_steps"]
        rec = trace.session(lambda i: self.step(self.state, self.pool[i % len(self.pool)]),
                            n, host)
        c = self.run.config["model"]["num_classes"]
        rec["labelled"] = [2 * inputs.counted(self.pool[i % len(self.pool)]["label"], c)
                           for i in range(n)]
        return rec

    def release(self) -> None:
        del self.state, self.step
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "fp32", half_batch: bool = False) -> dict:
        """The reference's readings of the same first step, from the same weights (made
        again from the seed) and batch."""
        return reference(self.run, self.pool, precision, half_batch)

    def check(self) -> dict:
        """The numbers compared: the program's readings against the reference's, and
        the program's first loss terms against the reference's loss on the program's
        own first logits."""
        own = loss_terms(self.run, self.pool, self.readings["own"])
        return {**compare.train_numbers(self.readings, self.reference()),
                **compare.loss_core_numbers(self.readings["parts"], own)}


def reference(run, pool: List[dict], precision: str = "fp32",
              half_batch: bool = False) -> dict:
    from .. import harness

    cfg, seed, dev = run.config, run.seed, run.device
    model = cfg["model"]
    ref = harness.reference_module(run.workload["config"])
    weights = inputs.model_weights(seed, "student", model, dev, model["openset"])
    ntm = None
    if cfg["stage"] == "simt":
        weights = {"student": weights,
                   "teacher": inputs.model_weights(seed, "teacher", model, dev, False)}
        ntm = inputs.ntm_params(seed, model, dev)
    with ieee_fp32():
        return ref.train(cfg, weights, ntm, pool[0], precision=precision,
                         half_batch=half_batch)


def loss_terms(run, pool: List[dict], own: Dict[str, torch.Tensor],
               precision: str = "fp32") -> Dict[str, float]:
    """The reference's loss terms of the first step from the logits ``own``, on the
    first batch's images that they hold, with the initial T1 / T2."""
    from .. import harness

    ntm = inputs.ntm_params(run.seed, run.config["model"], run.device)
    n = own["x1"].shape[0]
    batch = {k: v[:n] for k, v in pool[0].items()}
    with ieee_fp32():
        return harness.reference_module(run.workload["config"]).loss_terms(
            run.config, own, batch, ntm, precision)


def _event() -> torch.cuda.Event:
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
