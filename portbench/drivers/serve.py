"""Serving cells: one client in a closed loop sends requests to the
flagship iMDBN, each a batch of ``batch`` rows of one of the traffic's
calls (``txt2img``, ``img2txt``, ``sample_txt2img``), the calls in an
order drawn from the seed, every block of as many requests as there are
calls holding each call once. Labels are uniform over the classes,
images rows of the seed's dataset. A request is timed on the host clock
from its issue to its answer being in a pinned host buffer.

Set-up builds the model from the seed's weights, sets the joint's
biases and class means from the data through the model's own
``init_joint_bias_from_data``, and issues each call once (each call's
graph is captured then) and sends ``warm_seconds`` of requests; the
joint RBM's key stream is then restarted from the seed, so the reference
knows the key of every request of the window. A sample of each call's
requests, drawn from the seed as they complete (a reservoir), is kept
and compared with the reference once the window has closed."""

from __future__ import annotations

import gc
import random
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import inputs
from portbench.reference import joint as ref_joint
from portbench.reference import keys
from portbench.reference import rbm as ref_rbm
from portbench.drivers.train import FIELDS, _Data, params

KEY_STREAM_TAG = 0x5E12E
ROW_OFF = 1e-3     # a row of a sampled answer differs if any pixel does


class Driver:
    """A serving cell; each call's span is named after the call."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, spans):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.spans = spans
        self.calls = list(traffic["calls"])
        self.batch = int(traffic["batch"])
        self.keep = int(traffic["check_per_call"])
        m = cfg["model"]
        self.image_sizes = list(m["image_layers"])
        self.Dz, self.K = self.image_sizes[-1], int(m["num_labels"])
        self.steps = int(cfg["training"]["cross_gibbs_steps"])
        self.next_request = 0

    # -- traffic ---------------------------------------------------------------

    def request(self, i: int):
        """(call, its argument) of request ``i``: labels [batch] or the
        indices of ``batch`` dataset rows, drawn from (seed, i)."""
        block, pos = divmod(i, len(self.calls))
        order = random.Random(keys.fold_in(self.seed, block)).sample(
            self.calls, len(self.calls))
        call = order[pos]
        rng = np.random.default_rng(keys.fold_in(self.seed, 1_000_003 + i))
        if call == "img2txt":
            return call, rng.integers(0, self.n, self.batch)
        return call, rng.integers(0, self.K, self.batch)

    # -- set-up ----------------------------------------------------------------

    def setup(self) -> None:
        from multimodal_idbn_tpu_torch.device import set_matmul_precision
        from multimodal_idbn_tpu_torch.models.imdbn import iMDBN
        from multimodal_idbn_tpu_torch.ops.rbm_ops import RBMState
        cfg, dev = self.cfg, self.device
        set_matmul_precision(cfg["training"]["matmul_precision"])
        d = cfg["dataset"]
        self.n = inputs.n_train(cfg)
        self.data, cls = inputs.dot_images(self.seed, self.n, d["side"],
                                           self.K, dev)
        self.onehot = torch.nn.functional.one_hot(cls, self.K).float()
        self.image_init = inputs.rbm_weights(self.seed, self.image_sizes,
                                             dev)
        self.joint_init = inputs.rbm_weights(
            self.seed, [self.Dz + self.K, cfg["model"]["joint_hidden"]],
            dev, stream=20)[0]
        loader = _Data(self.batch, self.data.cpu().numpy(),
                       self.onehot.cpu().numpy())
        model = iMDBN(self.image_sizes, cfg["model"]["joint_hidden"],
                      params=params(cfg, self.seed), dataloader=loader,
                      num_labels=self.K, seed=self.seed, device=dev)
        for layer, st in zip(model.image_idbn.layers, self.image_init):
            layer.state = RBMState(**{f: st[f].clone() for f in FIELDS})
        model.joint_rbm.state = RBMState(
            **{f: self.joint_init[f].clone() for f in FIELDS})
        model.init_joint_bias_from_data(n_batches=10)
        self.model = model
        self.pinned: Dict[tuple, torch.Tensor] = {}
        # each call once (its capture), then ``warm_seconds`` of the
        # window's own requests: the card's clocks and the allocator
        # settle before the window
        for i in range(len(self.calls)):
            self._host(self._issue(*self.request(i)))
        i = len(self.calls)
        deadline = time.perf_counter() + float(self.traffic["warm_seconds"])
        while time.perf_counter() < deadline:
            self._host(self._issue(*self.request(i)))
            i += 1
        self.key_seed = keys.fold_in(self.seed, KEY_STREAM_TAG) >> 1
        model.joint_rbm.reseed(self.key_seed)
        self.kept: Dict[str, List] = {c: [] for c in self.calls}
        self.seen = {c: 0 for c in self.calls}
        self.pick = random.Random(keys.fold_in(self.seed, 7))

    def _issue(self, call: str, arg) -> torch.Tensor:
        m = self.model
        if call == "img2txt":
            rows = torch.as_tensor(arg, device=self.device)
            return m.img2txt(self.data.index_select(0, rows))
        if call == "txt2img":
            return m.txt2img(arg)
        return m.sample_txt2img(arg)

    # -- the window --------------------------------------------------------------

    def _host(self, out: torch.Tensor) -> torch.Tensor:
        """The answer copied into a pinned host buffer of its shape (the
        copy is waited for)."""
        if self.device.type != "cuda":
            return out.clone()
        buf = self.pinned.get(tuple(out.shape))
        if buf is None:
            buf = torch.empty(out.shape, pin_memory=True)
            self.pinned[tuple(out.shape)] = buf
        buf.copy_(out)
        return buf

    def _one(self) -> float:
        i = self.next_request
        call, arg = self.request(i)
        t0 = time.perf_counter()
        with self.spans(call):
            out = self._host(self._issue(call, arg))
        ms = (time.perf_counter() - t0) * 1e3
        self.seen[call] += 1
        kept = self.kept[call]
        if len(kept) < self.keep:
            kept.append((i, out.clone()))
        else:
            j = self.pick.randrange(self.seen[call])
            if j < self.keep:
                kept[j] = (i, out.clone())
        self.next_request += 1
        return ms

    def window(self, seconds: float) -> dict:
        lat = []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            lat.append(self._one())
        wall = time.perf_counter() - t0
        self.latencies = lat
        p95 = float(np.percentile(np.asarray(lat), 95, method="linear"))
        return dict(metrics={"serve_ms_p95": p95,
                             "serve_requests_per_s": len(lat) / wall},
                    attempted=len(lat), failed=0)

    def stretch(self) -> int:
        n = int(self.traffic["trace_requests"])
        self.stretch_start = self.next_request
        self.latencies = [self._one() for _ in range(n)]
        return n

    def span_names(self):
        return tuple(self.calls)

    def attempts_per_unit(self) -> int:
        return 1

    def chain_launches(self, units: int):
        """(B, V, H, steps, final pass, pulled columns) of every chain
        launch of the first ``units`` requests of the traced stretch."""
        out = []
        V, H = self.Dz + self.K, self.cfg["model"]["joint_hidden"]
        for i in range(self.stretch_start, self.stretch_start + units):
            call, _ = self.request(i)
            if call == "img2txt":
                out.append((self.batch, V, H, self.steps, True, 0))
            elif call == "txt2img":
                out.append((self.batch, V, H, self.steps, False, self.Dz))
        return out

    def free(self) -> None:
        del self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------------

    def _reference(self, ar: ref_rbm.Arith) -> Dict[str, List]:
        """Each kept request's answer by the reference computed with
        ``ar``, from the same inputs and keys."""
        dev = self.device
        image = [ref_rbm.clone(st) for st in self.image_init]
        joint = ref_rbm.clone(self.joint_init)
        limit = 10 * self.batch
        Z = ref_joint.represent(ar, image, self.data[:limit])
        zb, yb, zmean = ref_joint.bias_stats(Z, self.onehot[:limit], self.K)
        joint["vb"] = torch.cat([zb, yb, joint["vb"][self.Dz + self.K:]])
        last = max([i for v in self.kept.values() for i, _ in v],
                   default=-1)
        keys_ = ref_joint.next_keys(self.key_seed, last + 1)
        kw = dict(Dz=self.Dz, K=self.K, steps=self.steps)
        out = {c: [] for c in self.calls}
        for call, kept in self.kept.items():
            for i, _ in kept:
                _, arg = self.request(i)
                if call == "img2txt":
                    rows = torch.as_tensor(arg, device=dev)
                    ref = ref_joint.img2txt(
                        ar, image, joint, self.data.index_select(0, rows),
                        keys_[i], **kw)
                else:
                    y = torch.nn.functional.one_hot(
                        torch.as_tensor(arg, device=dev), self.K).float()
                    ref = (ref_joint.txt2img(ar, image, joint, y, zmean,
                                             keys_[i], **kw)
                           if call == "txt2img"
                           else ref_joint.sample_txt2img(
                               ar, image, joint, y, keys_[i], **kw))
                out[call].append(ref)
        return out

    @staticmethod
    def _gaps(answers: Dict[str, List], ref: Dict[str, List]
              ) -> Dict[str, float]:
        """The numbers compared: the widest gap of an ``img2txt`` and of a
        ``txt2img`` answer, and the share of the rows of the sampled
        answers that differ anywhere by more than ``ROW_OFF``."""
        rows = {c: torch.cat([(a.to(r.device) - r).abs().amax(dim=1)
                              for a, r in zip(answers[c], ref[c])])
                for c in ref if ref[c]}
        out = {}
        if "img2txt" in rows:
            out["img2txt_gap"] = float(rows["img2txt"].max())
        if "txt2img" in rows:
            out["txt2img_gap"] = float(rows["txt2img"].max())
        if "sample_txt2img" in rows:
            out["sample_rows_off"] = float(
                (rows["sample_txt2img"] > ROW_OFF).float().mean())
        return out

    def fp32_reference(self) -> Dict[str, List]:
        if getattr(self, "_ref", None) is None:
            self._ref = self._reference(ref_rbm.Arith())
        return self._ref

    def numbers(self) -> Dict[str, float]:
        return self._gaps({c: [o for _, o in v]
                           for c, v in self.kept.items()},
                          self.fp32_reference())

    def control_numbers(self, ar: ref_rbm.Arith) -> Dict[str, float]:
        """The numbers of the reference computed with ``ar`` put in the
        program's place."""
        return self._gaps(self._reference(ar), self.fp32_reference())
