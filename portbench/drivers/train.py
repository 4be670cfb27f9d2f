"""Training cells: a phase of a model trained epoch after epoch through
the model's own per-epoch entry, each epoch one CUDA graph replay.

The models' ``train`` / ``train_joint`` build a new epoch runner, and so
capture a new graph, at every call, and read one host value per epoch
through their loop over ``_train_epoch`` / ``_train_joint_epoch``. The
benchmark builds the runner as those entries do, once, and calls the
per-epoch entry: set-up runs the first ``check_steps`` epochs (the
capture happens in the first), then ``warm_seconds`` of epochs; the
window the epochs after them, in the schedule's order and past its end
by the model's own schedule formulas.

Set-up keeps what the first steps left (the loss of each step, the
momentum after step 1, the parameters after the last), and once the
window has closed the reference trains the same inputs from the same
initial weights through the same steps. Where the phase has a
``program_step``, the program also runs the window's next batch through
its exported batch step (the body its epochs replay) from the state the
window left, and the reference runs that batch from that same state.

``_train_epoch`` / ``_train_joint_epoch`` and the epoch runners are the
models' own per-epoch entries, which their ``train`` loops call; they are
the benchmark's contract with the port."""

from __future__ import annotations

import gc
import math
import time
from typing import Dict

import torch

from portbench import compare, counts, inputs
from portbench.reference import bimodal as ref_bimodal
from portbench.reference import flagship as ref_flagship
from portbench.reference import idbn as ref_idbn
from portbench.reference import joint as ref_joint
from portbench.reference import keys
from portbench.reference import rbm as ref_rbm

FIELDS = ref_rbm.FIELDS


def params(cfg: dict, seed: int, **override) -> dict:
    """The models' UPPERCASE params from a configuration file."""
    t = dict(cfg["training"], **override)
    return {
        "LEARNING_RATE": t["learning_rate"],
        "WEIGHT_PENALTY": t["weight_penalty"],
        "INIT_MOMENTUM": t["init_momentum"],
        "FINAL_MOMENTUM": t["final_momentum"],
        "LEARNING_RATE_DYNAMIC": t["learning_rate_dynamic"],
        "CD": t["cd"],
        "JOINT_LEARNING_RATE": t["joint_learning_rate"],
        "JOINT_CD": t["joint_cd"],
        "CROSS_GIBBS_STEPS": t["cross_gibbs_steps"],
        "JOINT_AUX_COND_STEPS": t["JOINT_AUX_COND_STEPS"],
        "JOINT_AUX_EVERY_K": t["JOINT_AUX_EVERY_K"],
        "CROSS_METRICS_EVERY": t["cross_metrics_every"],
        "DTYPE": t["dtype"],
        "SEED": int(seed),
    }


def lr_at(base: float, epoch: int, dynamic: bool) -> float:
    return base / (1.0 + 0.01 * epoch) if dynamic else base


def mom_at(init: float, final: float, epoch: int) -> float:
    return init if epoch <= 5 else final


class _Loader:
    """What the models read of a loader when they are driven by epoch:
    its batch size."""

    def __init__(self, batch_size: int):
        self.batch_size = int(batch_size)


def _host(d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().float().cpu() for k, v in d.items()}


class _Phase:
    """What the training phases share: a step is an epoch over the ``n``
    rows of the training split in batches of ``batch``; ``observed`` holds
    what set-up kept of the first steps, ``reference(arith)`` the same
    steps in the reference."""

    @property
    def rows_per_step(self) -> int:
        return self.n

    @property
    def batches_per_step(self) -> int:
        return len(counts.batch_sizes(self.n, self.batch))

    def fp32_reference(self) -> dict:
        if getattr(self, "_ref", None) is None:
            self._ref = self.reference(ref_rbm.Arith())
        return self._ref

    def fp32_step(self) -> dict:
        if getattr(self, "_ref_step", None) is None:
            self._ref_step = self.step_reference(ref_rbm.Arith())
        return self._ref_step

    def numbers(self) -> Dict[str, float]:
        out = compare.training_numbers(self.observed, self.fp32_reference())
        if hasattr(self, "step_observed"):
            out.update(compare.step_numbers(self.step_observed,
                                            self.fp32_step()))
        return out

    def control_numbers(self, ar: ref_rbm.Arith) -> Dict[str, float]:
        """The numbers of the reference computed with ``ar`` put in the
        program's place."""
        out = compare.training_numbers(self.reference(ar),
                                       self.fp32_reference())
        if hasattr(self, "step_observed"):
            out.update(compare.step_numbers(self.step_reference(ar),
                                            self.fp32_step()))
        return out

    def _step_start(self, states) -> None:
        """Keep on the host the state the window left, where the program's
        batch step and the reference's start."""
        self.step_start = [{f: getattr(st, f).detach().float().cpu().clone()
                            for f in FIELDS} for st in states]

    def _step_change(self, states) -> dict:
        return _host({f"layer{i}.{f}": getattr(st, f).float()
                      - self.step_start[i][f].to(self.device)
                      for i, st in enumerate(states)
                      for f in ("w", "hb", "vb")})

    def _start_states(self):
        return [{f: v.to(self.device) for f, v in st.items()}
                for st in self.step_start]


class ImagePhase(_Phase):
    """The image iDBN of the flagship: every layer on every batch, CD-k
    through the sampled half-step kernel."""

    span = "iDBN.train"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 dtype: str = None):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.sizes = list(cfg["model"]["image_layers"])
        self.batch = int(cfg["dataset"]["batch_size"])
        self.n = inputs.n_train(cfg)
        t = cfg["training"]
        self.cd = int(t["cd"])
        self.dtype = dtype or t["dtype"]
        self.params = params(cfg, seed, dtype=self.dtype)

    # -- set-up ------------------------------------------------------------

    def setup(self) -> None:
        from multimodal_idbn_tpu_torch.device import set_matmul_precision
        from multimodal_idbn_tpu_torch.models.idbn import iDBN
        from multimodal_idbn_tpu_torch.ops.rbm_ops import RBMState
        set_matmul_precision(self.cfg["training"]["matmul_precision"])
        d = self.cfg["dataset"]
        self.data, _ = inputs.dot_images(self.seed, self.n, d["side"],
                                         d["num_classes"], self.device)
        self.init = inputs.rbm_weights(self.seed, self.sizes, self.device)
        self.model = iDBN(self.sizes, self.params, _Loader(self.batch),
                          device=self.device, seed=self.seed)
        dt = self.model.layers[0].state.w.dtype
        for layer, st in zip(self.model.layers, self.init):
            layer.state = RBMState(**{f: st[f].to(dt) for f in FIELDS})
        self.runner = self.model._epoch_runner(self.data.clone(),
                                               self.batch)
        steps = int(self.traffic["check_steps"])
        losses = []
        for e in range(steps):
            losses.append(self.step(e))
            if e == 0:
                grads = _host(self._leaves(("w_m", "hb_m", "vb_m")))
        after = self._leaves(("w", "hb", "vb"))
        change = {k: v.float() - self.init[int(k[5:k.index(".")])][
            k.split(".")[1]] for k, v in after.items()}
        self.observed = dict(losses=losses, grads=grads,
                             change=_host(change))
        self.next_step = steps

    def _leaves(self, fields) -> Dict[str, torch.Tensor]:
        return {f"layer{i}.{f}": getattr(layer.state, f)
                for i, layer in enumerate(self.model.layers)
                for f in fields}

    # -- the window ----------------------------------------------------------

    def step(self, epoch: int) -> float:
        """One epoch through the model's per-epoch entry; its loss."""
        loss = self.model._train_epoch(epoch, self.runner, self.batch)
        self.model.loss_history.append(loss)
        return loss

    def flops_per_step(self) -> float:
        return counts.image_epoch_flops(self.sizes, self.cd, self.n,
                                        self.batch)

    def half_step_shapes(self):
        return counts.image_half_steps(self.sizes, self.cd, self.n,
                                       self.batch)

    def _next_batch(self):
        """(key, rows) of batch 0 of epoch ``next_step``."""
        ekey = keys.fold_in(self.seed, self.next_step)
        rows = keys.permutation(ekey, self.n)[:self.batch]
        return keys.fold_in(ekey, 0), rows.to(self.device)

    def program_step(self) -> None:
        """The window's next batch through the program's exported batch
        step (``dbn_train.idbn_batch_step``, the body of its epochs) from
        the state the window left."""
        from multimodal_idbn_tpu_torch.ops import dbn_train
        t, e = self.cfg["training"], self.next_step
        key, rows = self._next_batch()
        kw = self.model._epoch_kw(self.batch)
        del kw["batch_size"]
        wd, sf = kw.pop("weight_decay"), kw.pop("sparsity_factor")
        before = self.model.states()
        self._step_start(before)
        after, losses = dbn_train.idbn_batch_step(
            before, key, self.data.index_select(0, rows),
            lr_at(t["learning_rate"], e, t["learning_rate_dynamic"]),
            mom_at(t["init_momentum"], t["final_momentum"], e), wd, sf,
            **kw)
        self.step_observed = dict(
            losses=[float(x) for x in losses.float().cpu()],
            change=self._step_change(after))

    def step_reference(self, ar: ref_rbm.Arith) -> dict:
        """That batch in the reference, from the same state."""
        t, e = self.cfg["training"], self.next_step
        key, rows = self._next_batch()
        start = self._start_states()
        out, losses = ref_idbn.batch_step(
            ar, [ref_rbm.clone(st) for st in start], key,
            self.data.index_select(0, rows),
            lr=lr_at(t["learning_rate"], e, t["learning_rate_dynamic"]),
            mom=mom_at(t["init_momentum"], t["final_momentum"], e),
            wd=t["weight_penalty"], cd=self.cd)
        return dict(losses=losses, change=_host(
            {f"layer{i}.{f}": st[f] - start[i][f]
             for i, st in enumerate(out) for f in ("w", "hb", "vb")}))

    def free(self) -> None:
        del self.model, self.runner
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference ---------------------------------------------------------

    def reference(self, arith: ref_rbm.Arith) -> dict:
        """The first steps in the reference from the same inputs."""
        t = self.cfg["training"]
        layers = [ref_rbm.clone(st) for st in self.init]
        losses = []
        for e in range(int(self.traffic["check_steps"])):
            layers, loss = ref_idbn.epoch(
                arith, layers, self.data, keys.fold_in(self.seed, e),
                lr=lr_at(t["learning_rate"], e, t["learning_rate_dynamic"]),
                mom=mom_at(t["init_momentum"], t["final_momentum"], e),
                wd=t["weight_penalty"], cd=self.cd, batch=self.batch)
            losses.append(loss)
            if e == 0:
                grads = _host({f"layer{i}.{f}": st[f]
                               for i, st in enumerate(layers)
                               for f in ("w_m", "hb_m", "vb_m")})
        change = {f"layer{i}.{f}": st[f] - self.init[i][f]
                  for i, st in enumerate(layers) for f in ("w", "hb", "vb")}
        return dict(losses=losses, grads=grads, change=_host(change))


class _Data(_Loader):
    """A loader that hands over its whole split (``materialize``)."""

    def __init__(self, batch_size, *arrays):
        super().__init__(batch_size)
        self._arrays = arrays

    def materialize(self):
        return self._arrays


class _Pairs(_Loader):
    """Both modalities' rows, in order, in batches: what the bimodal
    model reads of its loader to set the joint's biases."""

    def __init__(self, batch_size, v1, v2):
        super().__init__(batch_size)
        self.v1, self.v2 = v1, v2

    def __iter__(self):
        for s in range(0, self.v1.shape[0], self.batch_size):
            yield (self.v1[s:s + self.batch_size],
                   self.v2[s:s + self.batch_size])


class BimodalJointPhase(_Phase):
    """The bimodal iMDBN's joint DBN: the model's warm-up epochs and its
    main epochs (sampled CD-k down the stack, two clamped updates whose
    noisy inits run on the chain kernel, both cross-reconstructions),
    each epoch through the epoch runner ``train_joint`` builds, replayed;
    MOD1 and MOD2 frozen. Set-up runs the warm-up, then the first
    ``check_steps`` main epochs; the window the main epochs after them."""

    span = "iMDBN_BiModal.train_joint"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 dtype: str = None):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        m, t = cfg["model"], cfg["training"]
        self.mod1_sizes = list(m["mod1_layers"])
        self.mod2_sizes = list(m["mod2_layers"])
        self.Dz1, self.Dz2 = self.mod1_sizes[-1], self.mod2_sizes[-1]
        self.joint_sizes = [self.Dz1 + self.Dz2] + list(m["joint_hidden"])
        self.batch = int(cfg["dataset"]["batch_size"])
        self.n = inputs.n_train(cfg)
        self.warmup = int(traffic["warmup_epochs"])
        self.dtype = dtype or t["dtype"]
        self.params = params(cfg, seed, dtype=self.dtype)
        self.kw = dict(joint_cd=int(t["joint_cd"]),
                       init_steps=max(10, int(t["JOINT_AUX_COND_STEPS"])),
                       steps=int(t["cross_gibbs_steps"]))

    def setup(self) -> None:
        from multimodal_idbn_tpu_torch.device import set_matmul_precision
        from multimodal_idbn_tpu_torch.models.imdbn_bimodal import \
            iMDBN_BiModal
        from multimodal_idbn_tpu_torch.ops.rbm_ops import RBMState
        cfg, dev = self.cfg, self.device
        set_matmul_precision(cfg["training"]["matmul_precision"])
        d = cfg["dataset"]
        self.v1, cls = inputs.dot_images(self.seed, self.n, d["side"],
                                         d["num_classes"], dev)
        self.v2 = inputs.second_modality(self.seed, cls, self.mod2_sizes[0],
                                         d["num_classes"], dev)
        self.mod1_init = inputs.rbm_weights(self.seed, self.mod1_sizes, dev)
        self.mod2_init = inputs.rbm_weights(self.seed, self.mod2_sizes, dev,
                                            stream=11)
        self.joint_init = inputs.rbm_weights(self.seed, self.joint_sizes,
                                             dev, stream=12)
        model = iMDBN_BiModal(
            self.mod1_sizes, self.mod2_sizes, list(cfg["model"][
                "joint_hidden"]), params=self.params,
            dataloader=_Pairs(self.batch, self.v1, self.v2), device=dev,
            seed=self.seed)
        dt = model.joint_rbm.state.w.dtype
        for layers, init in ((model.mod1_dbn.layers, self.mod1_init),
                             (model.mod2_dbn.layers, self.mod2_init),
                             (model.joint_layers, self.joint_init)):
            for layer, st in zip(layers, init):
                layer.state = RBMState(**{f: st[f].to(dt) for f in FIELDS})
        model.init_joint_bias_from_data(n_batches=10)
        self.model = model
        self.V1, self.V2 = self.v1.clone(), self.v2.clone()
        self.Z1, self.Z2 = model._latents(self.V1, self.V2)
        self.runners = {}
        for e in range(self.warmup):
            self.step(e)
        before = self._leaves(("w", "hb", "vb"))
        before = {k: v.float().clone() for k, v in before.items()}
        steps = int(self.traffic["check_steps"])
        losses, metrics = [], []
        for e in range(self.warmup, self.warmup + steps):
            losses.append(self.step(e))
            metrics.append(self.last_mse)
            if e == self.warmup:
                grads = _host(self._leaves(("w_m", "hb_m", "vb_m")))
        after = self._leaves(("w", "hb", "vb"))
        self.observed = dict(
            losses=losses, metrics=metrics, grads=grads,
            change=_host({k: v.float() - before[k]
                          for k, v in after.items()}))
        self.next_step = self.warmup + steps

    def _leaves(self, fields) -> Dict[str, torch.Tensor]:
        return {f"layer{i}.{f}": getattr(layer.state, f)
                for i, layer in enumerate(self.model.joint_layers)
                for f in fields}

    def step(self, epoch: int) -> float:
        """One joint epoch as ``train_joint`` runs it: the runner of its
        setting (warm-up or main), the epoch's replay, the joint states
        set, the metric sums read on the host. Returns the epoch's mean
        layer-0 CD loss (0 in the warm-up)."""
        from multimodal_idbn_tpu_torch.ops import bimodal_ops
        m = self.model
        jr = m.joint_rbm
        warm = epoch < self.warmup
        statics = dict(warmup=warm, joint_cd=m.joint_cd,
                       aux_cond_steps=int(self.params[
                           "JOINT_AUX_COND_STEPS"]),
                       Dz1=m.Dz_mod1, steps=m.cross_steps, sr=jr.sr)
        mod1, mod2 = m.mod1_dbn.states(), m.mod2_dbn.states()
        if warm not in self.runners:
            self.runners[warm] = bimodal_ops.bimodal_epoch_runner(
                self.Z1, self.Z2, self.V1, self.V2, mod1, mod2,
                jr.weight_decay, batch_size=self.batch, metrics_every=1,
                graphed=self.device.type == "cuda", **statics)
        joint, sums, counts, totals = bimodal_ops.bimodal_epoch_block(
            m._joint_states(), mod1, mod2, int(self.params["SEED"]) + 11,
            self.Z1, self.Z2, self.V1, self.V2, [epoch],
            [lr_at(jr.lr, epoch, jr.dynamic_lr)],
            [mom_at(jr.momentum, jr.final_momentum, epoch)],
            jr.weight_decay, batch_size=self.batch, metrics_every=1,
            runner=self.runners[warm], **statics)
        m._set_joint_states(joint)
        tot = {k: float(v) for k, v in totals[0]._asdict().items()}
        self.last_mse = [tot["mse_mod1"], tot["mse_mod2"]]
        return float(sums[0]) / counts[0] if counts[0] else 0.0

    def flops_per_step(self) -> float:
        return counts.bimodal_main_epoch_flops(
            self.joint_sizes, self.mod1_sizes, self.mod2_sizes,
            self.n, self.batch, **self.kw)

    def chain_launches(self, units: int):
        """Two clamped noisy inits a main batch on layer 0."""
        V, H = self.joint_sizes[0], self.joint_sizes[1]
        return [(B, V, H, self.kw["init_steps"], False, 0)
                for B in counts.batch_sizes(self.n, self.batch)
                for _ in range(2)] * units

    def _next_batch(self):
        """(key, rows) of batch 0 of main epoch ``next_step``."""
        ekey = keys.fold_in(int(self.params["SEED"]) + 11, self.next_step)
        rows = keys.permutation(ekey, self.n)[:self.batch]
        return keys.fold_in(keys.fold_in(ekey, 0), 0), rows.to(self.device)

    def program_step(self) -> None:
        """The window's next batch through the program's exported batch
        step (``bimodal_ops.bimodal_batch_step``, the body of its epochs)
        from the state the window left."""
        from multimodal_idbn_tpu_torch.ops import bimodal_ops
        m, e = self.model, self.next_step
        jr = m.joint_rbm
        key, rows = self._next_batch()
        before = m._joint_states()
        self._step_start(before)
        z1, z2, v1, v2 = (a.index_select(0, rows) for a in
                          (self.Z1, self.Z2, self.V1, self.V2))
        after, loss, met = bimodal_ops.bimodal_batch_step(
            before, m.mod1_dbn.states(), m.mod2_dbn.states(), key, z1, z2,
            v1, v2, lr_at(jr.lr, e, jr.dynamic_lr),
            mom_at(jr.momentum, jr.final_momentum, e), jr.weight_decay,
            warmup=False, joint_cd=m.joint_cd,
            aux_cond_steps=int(self.params["JOINT_AUX_COND_STEPS"]),
            Dz1=m.Dz_mod1, steps=m.cross_steps, compute_metrics=True,
            sr=jr.sr)
        self.step_observed = dict(
            losses=[float(loss)], metrics=[float(met[1]), float(met[2])],
            change=self._step_change(after))

    def step_reference(self, ar: ref_rbm.Arith) -> dict:
        """That batch in the reference, from the same joint state, its
        latents worked out again from the inputs."""
        t, e = self.cfg["training"], self.next_step
        key, rows = self._next_batch()
        v1, v2 = self.v1.index_select(0, rows), self.v2.index_select(0, rows)
        start = self._start_states()
        joint, loss, sums = ref_bimodal.batch_step(
            ar, [ref_rbm.clone(st) for st in start], self.mod1_init,
            self.mod2_init, key, ref_joint.represent(ar, self.mod1_init, v1),
            ref_joint.represent(ar, self.mod2_init, v2), v1, v2,
            lr=lr_at(t["joint_learning_rate"], e, t["learning_rate_dynamic"]),
            mom=mom_at(t["init_momentum"], t["final_momentum"], e),
            wd=t["weight_penalty"], warmup=False, **self.kw)
        return dict(losses=[loss], metrics=list(sums[1:]), change=_host(
            {f"layer{i}.{f}": st[f] - start[i][f]
             for i, st in enumerate(joint) for f in ("w", "hb", "vb")}))

    def free(self) -> None:
        del self.model, self.runners
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, ar: ref_rbm.Arith) -> dict:
        """Warm-up and the first main epochs in the reference, from the
        same inputs and initial weights."""
        t = self.cfg["training"]
        mod1 = [ref_rbm.clone(s) for s in self.mod1_init]
        mod2 = [ref_rbm.clone(s) for s in self.mod2_init]
        joint = [ref_rbm.clone(s) for s in self.joint_init]
        Z1 = ref_joint.represent(ar, mod1, self.v1)
        Z2 = ref_joint.represent(ar, mod2, self.v2)
        rows = min(self.n, 10 * self.batch)
        means = [torch.clamp(z[:rows].sum(0) / rows, 1e-4, 1 - 1e-4)
                 for z in (Z1, Z2)]
        joint[0]["vb"] = torch.cat([torch.log(mz) - torch.log1p(-mz)
                                    for mz in means])
        key = int(self.params["SEED"]) + 11
        nb = len(counts.batch_sizes(self.n, self.batch))
        losses, metrics = [], []
        steps = int(self.traffic["check_steps"])
        for e in range(self.warmup + steps):
            if e == self.warmup:
                before = {f"layer{i}.{f}": st[f].clone()
                          for i, st in enumerate(joint)
                          for f in ("w", "hb", "vb")}
            joint, loss_sum, sums = ref_bimodal.epoch(
                ar, joint, mod1, mod2, Z1, Z2, self.v1, self.v2,
                keys.fold_in(key, e), batch=self.batch,
                lr=lr_at(t["joint_learning_rate"], e,
                         t["learning_rate_dynamic"]),
                mom=mom_at(t["init_momentum"], t["final_momentum"], e),
                wd=t["weight_penalty"], warmup=e < self.warmup, **self.kw)
            if e >= self.warmup:
                losses.append(loss_sum / nb)
                metrics.append(sums[1:])
            if e == self.warmup:
                grads = _host({f"layer{i}.{f}": st[f]
                               for i, st in enumerate(joint)
                               for f in ("w_m", "hb_m", "vb_m")})
        change = {k: joint[int(k[5:k.index(".")])][k.split(".")[1]] - v
                  for k, v in before.items()}
        return dict(losses=losses, metrics=metrics, grads=grads,
                    change=_host(change))


class FlagshipJointPhase(_Phase):
    """The flagship iMDBN's joint RBM: the model's warm-up epochs and its
    main epochs (sampled CD-k with the label softmax, the y-clamped
    update and on batch 0 of every 50 the z-clamped one, their noisy
    inits and both halves of the cross-modal round trip on the chain
    kernel), each through the model's per-epoch entry
    ``_train_joint_epoch`` with the runners ``train_joint`` builds; the
    image iDBN frozen. Set-up runs the warm-up, then the first
    ``check_steps`` main epochs; the window the main epochs after them."""

    span = "iMDBN.train_joint"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 dtype: str = None):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        m, t = cfg["model"], cfg["training"]
        self.image_sizes = list(m["image_layers"])
        self.Dz, self.K = self.image_sizes[-1], int(m["num_labels"])
        self.H = int(m["joint_hidden"])
        self.batch = int(cfg["dataset"]["batch_size"])
        self.n = inputs.n_train(cfg)
        self.warmup = int(traffic["warmup_epochs"])
        self.dtype = dtype or t["dtype"]
        self.params = params(cfg, seed, dtype=self.dtype)
        self.kw = dict(joint_cd=int(t["joint_cd"]),
                       init_steps=max(10, int(t["JOINT_AUX_COND_STEPS"])),
                       steps=int(t["cross_gibbs_steps"]))

    def setup(self) -> None:
        from multimodal_idbn_tpu_torch.device import set_matmul_precision
        from multimodal_idbn_tpu_torch.models.imdbn import iMDBN
        from multimodal_idbn_tpu_torch.ops.rbm_ops import RBMState
        cfg, dev = self.cfg, self.device
        set_matmul_precision(cfg["training"]["matmul_precision"])
        d = cfg["dataset"]
        self.x, cls = inputs.dot_images(self.seed, self.n, d["side"],
                                        self.K, dev)
        self.y = torch.nn.functional.one_hot(cls, self.K).float()
        self.image_init = inputs.rbm_weights(self.seed, self.image_sizes,
                                             dev)
        self.joint_init = inputs.rbm_weights(
            self.seed, [self.Dz + self.K, self.H], dev, stream=20)[0]
        model = iMDBN(self.image_sizes, self.H, params=self.params,
                      dataloader=_Data(self.batch, self.x.cpu().numpy(),
                                       self.y.cpu().numpy()),
                      num_labels=self.K, seed=self.seed, device=dev)
        dt = model.joint_rbm.state.w.dtype
        for layer, st in zip(model.image_idbn.layers, self.image_init):
            layer.state = RBMState(**{f: st[f].to(dt) for f in FIELDS})
        model.joint_rbm.state = RBMState(
            **{f: self.joint_init[f].to(dt) for f in FIELDS})
        X, Y, Z = model._materialized_train()
        model.init_joint_bias_from_data(n_batches=10, _cached=(X, Y, Z))
        model.joint_metrics_history = []
        self.model = model
        self.args = (X, Y, Z, self.batch, model.image_idbn.states(),
                     int(self.params["JOINT_AUX_COND_STEPS"]),
                     int(self.params["CROSS_METRICS_EVERY"]), {})
        for e in range(self.warmup):
            self.step(e)
        st = model.joint_rbm.state
        before = {f"joint.{f}": getattr(st, f).float().clone()
                  for f in ("w", "hb", "vb")}
        steps = int(self.traffic["check_steps"])
        losses, metrics = [], []
        for e in range(self.warmup, self.warmup + steps):
            losses.append(self.step(e))
            metrics.append(list(model.last_metrics.values()))
            if e == self.warmup:
                st = model.joint_rbm.state
                grads = _host({f"joint.{f}": getattr(st, f)
                               for f in ("w_m", "hb_m", "vb_m")})
        st = model.joint_rbm.state
        self.observed = dict(
            losses=losses, metrics=metrics, grads=grads,
            change=_host({k: getattr(st, k[6:]).float() - v
                          for k, v in before.items()}))
        self.next_step = self.warmup + steps

    def step(self, epoch: int) -> float:
        """One joint epoch through ``_train_joint_epoch``; the mean of the
        free-CD losses it reports (0 in the warm-up)."""
        losses = self.model._train_joint_epoch(epoch, *self.args)
        return sum(losses) / len(losses) if losses else 0.0

    def flops_per_step(self) -> float:
        return counts.flagship_joint_epoch_flops(
            self.Dz + self.K, self.H, self.image_sizes, self.n, self.batch,
            **self.kw)

    def chain_launches(self, units: int):
        """Per main batch: the y-clamped init, the round trip's two
        halves; on batch 0 the z-clamped init too."""
        V, H, kw = self.Dz + self.K, self.H, self.kw
        out = []
        for b, B in enumerate(counts.batch_sizes(self.n, self.batch)):
            out.append((B, V, H, kw["init_steps"], False, 0))
            if b % ref_flagship.ZCLAMP_EVERY == 0:
                out.append((B, V, H, kw["init_steps"], False, 0))
            out.append((B, V, H, kw["steps"], True, 0))
            out.append((B, V, H, kw["steps"], False, self.Dz))
        return out * units

    def free(self) -> None:
        del self.model, self.args
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, ar: ref_rbm.Arith) -> dict:
        """Warm-up and the first main epochs in the reference, from the
        same inputs and initial weights."""
        t = self.cfg["training"]
        image = [ref_rbm.clone(s) for s in self.image_init]
        joint = ref_rbm.clone(self.joint_init)
        Z = ref_joint.represent(ar, image, self.x)
        rows = min(self.n, 10 * self.batch)
        zb, yb, zmean = ref_joint.bias_stats(Z[:rows], self.y[:rows], self.K)
        joint["vb"] = torch.cat([zb, yb, joint["vb"][self.Dz + self.K:]])
        npix = self.x.shape[1]
        losses, metrics = [], []
        steps = int(self.traffic["check_steps"])
        for e in range(self.warmup + steps):
            if e == self.warmup:
                before = {f"joint.{f}": joint[f].clone()
                          for f in ("w", "hb", "vb")}
            joint, ls, m = ref_flagship.epoch(
                ar, joint, image, Z, self.y, self.x, zmean,
                keys.fold_in(int(self.params["SEED"]) + 7, e),
                batch=self.batch,
                lr=lr_at(t["joint_learning_rate"], e,
                         t["learning_rate_dynamic"]),
                mom=mom_at(t["init_momentum"], t["final_momentum"], e),
                wd=t["weight_penalty"], warmup=e < self.warmup, **self.kw)
            if e >= self.warmup:
                losses.append(sum(ls) / len(ls))
                metrics.append([m[1] / m[0], m[2] / m[0], m[3] / m[0],
                                m[4] / max(1.0, m[0] * npix)])
            if e == self.warmup:
                grads = _host({f"joint.{f}": joint[f]
                               for f in ("w_m", "hb_m", "vb_m")})
        return dict(losses=losses, metrics=metrics, grads=grads,
                    change=_host({k: joint[k[6:]] - v
                                  for k, v in before.items()}))


PHASES = {"image": ImagePhase, "bimodal_joint": BimodalJointPhase,
          "flagship_joint": FlagshipJointPhase}


class Driver:
    """A training cell: the phase named by the traffic file."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, spans,
                 **phase_kw):
        self.phase = PHASES[traffic["phase"]](cfg, traffic, seed, device,
                                              **phase_kw)
        self.traffic = traffic
        self.spans = spans

    def setup(self) -> None:
        """The phase's set-up and first steps, then ``warm_seconds`` of
        the window's own epochs: the card's clocks and the allocator
        settle before the window."""
        self.phase.setup()
        ph = self.phase
        deadline = time.perf_counter() + float(self.traffic["warm_seconds"])
        while time.perf_counter() < deadline:
            ph.step(ph.next_step)
            ph.next_step += 1

    def window(self, seconds: float) -> dict:
        """Epochs until ``seconds`` have passed; the rate over all the
        rows they trained and all the window's time, under the traffic's
        ``rate_metric``."""
        ph = self.phase
        first = e = ph.next_step
        failed = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            with self.spans(ph.span):
                loss = ph.step(e)
            failed += 0 if math.isfinite(loss) else ph.batches_per_step
            e += 1
        if ph.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ph.next_step = e
        return dict(metrics={self.traffic["rate_metric"]:
                             (e - first) * ph.rows_per_step / wall},
                    attempted=(e - first) * ph.batches_per_step,
                    failed=failed)

    def stretch(self) -> int:
        """The traced stretch: ``trace_steps`` epochs."""
        ph = self.phase
        n = int(self.traffic["trace_steps"])
        for e in range(ph.next_step, ph.next_step + n):
            with self.spans(ph.span):
                ph.step(e)
        ph.next_step += n
        return n

    def span_names(self):
        return (self.phase.span,)

    def attempts_per_unit(self) -> int:
        return self.phase.batches_per_step

    def free(self) -> None:
        """The program's batch step from the state the window left, where
        the phase has one; then its state freed."""
        if hasattr(self.phase, "program_step"):
            self.phase.program_step()
        self.phase.free()

    def numbers(self) -> Dict[str, float]:
        return self.phase.numbers()

    def control_numbers(self, ar: ref_rbm.Arith) -> Dict[str, float]:
        return self.phase.control_numbers(ar)
