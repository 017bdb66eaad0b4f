"""The general traffic generator: one loop per ``kind`` of traffic file,
every size and count read from the file.

* ``train``: a closed loop of training steps at ``batch`` over a pool of
  ``pool`` seeded device-resident batches. The first ``check_steps`` steps
  of set-up are the ones the reference replays: their losses, the first
  update's gradient (from the optimizer's first moments after micro-step
  ``accumulation_steps - 1``, the configuration's ``train`` block saying
  how many micro-steps make an update; ``check_steps`` is a multiple of
  it) and the parameters after the last of them are kept. Set-up then
  runs the rest of the pool once (``warmup_steps`` in all), and the window
  runs steps until ``seconds`` have passed. The reference draws its
  stochastic-depth masks and its mixup from generators seeded as the
  program's.
* ``infer_batch``: a closed loop of eval forwards at ``batch`` over the
  pool (the reference's ``--throughput`` protocol over the whole window);
  ``check_calls`` of the window's answers are kept, drawn from the seed.
* ``infer_request``: one client, closed loop: each request is one image
  from a pool of ``pool`` in pinned host memory, copied to the card,
  run through an eval forward, its logits copied back to the host; the
  next is sent after the reply. Every reply is kept and checked.

A loop's ``window`` returns the end-to-end numbers, ``profile`` a trace
summary, and ``check`` the numbers of :mod:`check` (run after the
program's state is freed, with the reference on the same device).
"""

from __future__ import annotations

import gc
import random
import statistics
import time
from typing import List, Tuple

import torch

from . import check, data, program, reference, trace
from .reference.train import accumulation, mixes, replay_steps

GIB = 2.0 ** 30


class Loop:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 mutate=None):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = device
        self.batch = int(traffic["batch"])
        self.pool_size = int(traffic["pool"])
        self.img = int(cfg["img_size"])
        self.classes = int(cfg["model"].get("num_classes") or
                           cfg["model"]["arch"]["num_classes"])
        self.mask_seed = data.stream_seed(seed, data.MASKS)
        self.mutate = mutate  # tests: a fault planted in the timed path

    # ------------------------------------------------------------ shared
    def sync(self):
        if self.device.startswith("cuda"):
            torch.cuda.synchronize()

    def weights(self, module):
        return data.make_weights(data.float_state_shapes(module), self.seed,
                                 self.device)

    def batches(self):
        return data.make_batches(self.seed, self.pool_size, self.batch,
                                 self.img, self.classes, self.device)

    def build(self):
        if self.device.startswith("cuda"):
            program.build_kernels()
        self.prog = program.build(self.cfg, self.device, self.seed,
                                  self.weights)

    def free(self):
        """Drop the program's state before the reference runs."""
        for name in ("prog", "step", "optimizer", "pool", "fwd"):
            self.__dict__.pop(name, None)
        gc.collect()
        if self.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def reference(self, precision="float32"):
        reference.no_tf32()
        ref = reference.build(self.cfg["model"], precision,
                              self.mask_seed).to(self.device)
        ref.load_state_dict(self.weights(ref), strict=False)
        return ref

    def peak_reset(self):
        if self.device.startswith("cuda"):
            torch.cuda.reset_peak_memory_stats()

    def peak_bytes(self) -> int:
        if self.device.startswith("cuda"):
            return int(torch.cuda.max_memory_allocated())
        return 0

    def profile(self, steps):
        """The trace events of ``steps`` more calls."""
        return trace.profile(self._one, steps, self.sync)

    def answers(self, precision="float32") -> List[torch.Tensor]:
        """The reference's logits for each input of the pool."""
        ref = self.reference(precision)
        with torch.no_grad():
            return [ref(x).float().cpu() for x in self.inputs()]

    def timed(self, seconds: float, one) -> Tuple[int, float]:
        """Calls of ``one(i)`` until ``seconds`` have passed, then a
        synchronise: ``(calls, elapsed seconds)``. ``self.returns`` keeps
        the host clock at each call's return."""
        self.sync()
        t0 = time.perf_counter()
        self.returns = [t0]
        n = 0
        while True:
            one(n)
            n += 1
            self.returns.append(time.perf_counter())
            if self.returns[-1] - t0 >= seconds:
                break
        self.sync()
        return n, time.perf_counter() - t0


class TrainLoop(Loop):
    """A closed loop of ``train_step``s (kind ``train``)."""

    def setup(self):
        accum = accumulation(self.cfg["train"])
        if int(self.traffic["check_steps"]) % accum:
            raise ValueError(f"check_steps {self.traffic['check_steps']} is "
                             f"not a multiple of the {accum} micro-steps "
                             "of an update")
        self.build()
        self.pool = self.batches()
        self.step, self.optimizer = program.make_train_step(
            self.prog, self.cfg, self.mask_seed)
        if self.mutate:
            self.step = self.mutate(self, self.step)
        b1 = self.cfg["train"]["betas"][0]
        self.losses, self.failed = [], 0
        for i in range(int(self.traffic["warmup_steps"])):
            out = self.step(*self.pool[i % self.pool_size])
            if i < int(self.traffic["check_steps"]):
                self.losses.append(out["loss"].detach().float().cpu())
                if i == accum - 1:
                    self.grads = {k: (m / (1 - b1)).cpu() for k, m in
                                  program.first_moments(
                                      self.optimizer).items()}
                if i + 1 == int(self.traffic["check_steps"]):
                    model = self.prog["model"]
                    self.end = {k: p.detach().to("cpu", copy=True)
                                for k, p in model.named_parameters()}
        self.sync()

    def _one(self, i):
        out = self.step(*self.pool[i % self.pool_size])
        self.failed += not out["grads_finite"]

    def window(self, seconds):
        self.peak_reset()
        self.failed = 0
        n, t = self.timed(seconds, self._one)
        self.attempted = n
        return {"train_img_s": n * self.batch / t,
                "peak_mem_gib": self.peak_bytes() / GIB,
                "peak_bytes": self.peak_bytes(),
                "rate_img_s": n * self.batch / t}

    def replay(self, precision="float32") -> dict:
        """The reference's replay of the checked steps from the same
        weights, inputs and masks: losses, the first update's gradients,
        the parameters at the start and after the last step (on the
        host)."""
        ref = self.reference(precision)
        ref.set_checkpoint(True)
        if hasattr(ref, "upsample_generator"):
            ref.upsample_generator = torch.Generator().manual_seed(
                self.mask_seed)
        ref.drop_generator = torch.Generator(
            device=self.device).manual_seed(self.mask_seed)
        mix = None
        if mixes(self.cfg["train"]):
            mix = torch.Generator().manual_seed(self.mask_seed)
        start = {k: v.cpu() for k, v in self.weights(ref).items()}
        n = int(self.traffic["check_steps"])
        pool = self.batches()
        out = replay_steps(ref, [pool[i % len(pool)] for i in range(n)],
                           self.cfg["train"], self.classes, mix)
        return {"losses": out["losses"], "start": start,
                "grads": {k: v.cpu() for k, v in out["grads"].items()},
                "params": {k: v.cpu() for k, v in out["params"].items()}}

    def check(self):
        self.free()
        self.peak_reset()
        t0 = time.perf_counter()
        ref = self.replay()
        took, peak = time.perf_counter() - t0, self.peak_bytes() / GIB
        readings = check.train_readings([float(x) for x in self.losses],
                                        self.grads, ref["start"], self.end,
                                        ref)
        return {**readings, "_replay_s": took, "_replay_peak_gib": peak}


class InferBatchLoop(Loop):
    """A closed loop of eval forwards at a batch (kind ``infer_batch``)."""

    def setup(self):
        self.build()
        self.pool = [x for x, _ in self.batches()]
        self.fwd = program.serve(self.prog)
        if self.mutate:
            self.fwd = self.mutate(self, self.fwd)
        for i in range(int(self.traffic["warmup_calls"])):
            self.fwd(self.pool[i % self.pool_size])
        self.sync()
        self.kept: List = []
        self.rng = random.Random(data.stream_seed(self.seed, data.SAMPLE))
        self.failed = 0

    def _one(self, i):
        j = i % self.pool_size
        out = self.fwd(self.pool[j])
        k = int(self.traffic["check_calls"])
        if len(self.kept) < k:
            self.kept.append((j, out))
        else:
            r = self.rng.randrange(i + 1)
            if r < k:
                self.kept[r] = (j, out)

    def window(self, seconds):
        self.peak_reset()
        self.kept = []
        n, t = self.timed(seconds, self._one)
        self.attempted = n
        return {"infer_img_s": n * self.batch / t,
                "peak_mem_gib": self.peak_bytes() / GIB,
                "peak_bytes": self.peak_bytes(),
                "rate_img_s": n * self.batch / t}

    def inputs(self):
        return [x for x, _ in self.batches()]

    def check(self):
        kept = [(j, out.float().cpu()) for j, out in self.kept]
        self.kept = []
        self.free()
        answers = self.answers()
        return {"logit_gap": max(check.logit_gap(out, answers[j])
                                 for j, out in kept),
                "_answers": len(kept) * self.batch}


class InferRequestLoop(Loop):
    """One client sending single images, closed loop (kind
    ``infer_request``)."""

    def setup(self):
        self.build()
        self.pool = [x.cpu() for x in self.inputs()]
        if self.device.startswith("cuda"):
            self.pool = [x.pin_memory() for x in self.pool]
        self.fwd = program.serve(self.prog)
        if self.mutate:
            self.fwd = self.mutate(self, self.fwd)
        self.replies, self.latency_ms, self.failed = [], [], 0
        for i in range(int(self.traffic["warmup_calls"])):
            self._one(i)
        self.sync()

    def _one(self, i):
        j = i % self.pool_size
        t0 = time.perf_counter()
        x = self.pool[j].to(self.device, non_blocking=True)
        y = self.fwd(x).to("cpu")
        self.latency_ms.append((time.perf_counter() - t0) * 1e3)
        self.replies.append((j, y))

    def window(self, seconds):
        self.peak_reset()
        self.replies, self.latency_ms = [], []
        n, t = self.timed(seconds, self._one)
        self.attempted = n
        lat = self.latency_ms
        # a window that held one request (a slow host) has it as its tail
        p95 = statistics.quantiles(lat, n=100)[94] if n > 1 else lat[0]
        return {"infer_ms_p95": p95,
                "peak_mem_gib": self.peak_bytes() / GIB,
                "peak_bytes": self.peak_bytes(),
                "rate_img_s": n / t}

    def inputs(self):
        images = data.make_batches(self.seed, 1, self.pool_size, self.img,
                                   self.classes, self.device)[0][0]
        return list(images.split(1))

    def check(self):
        replies = [(j, y.float()) for j, y in self.replies]
        self.replies = []
        self.free()
        answers = self.answers()
        return {"logit_gap": max(check.logit_gap(y, answers[j])
                                 for j, y in replies),
                "_answers": len(replies)}


KINDS = {"train": TrainLoop, "infer_batch": InferBatchLoop,
         "infer_request": InferRequestLoop}
