"""Modality cells: the two modality stacks of a bimodal model, MOD1 then
MOD2, each trained epoch after epoch through its iDBN's own per-epoch
entry ``iDBN._train_epoch`` with the epoch runner its ``train`` builds
(one CUDA graph replay an epoch).

A step is one MOD1 epoch, then one MOD2 epoch, over the same ``n`` rows
of the training split; a sample is one row trained through both stacks.
The modality stacks of ``configs/<config>.json`` may name the unit type
of their visible layer (``mod1_visible``, ``mod2_visible``: "bernoulli",
the default, "gaussian" or "replicated_softmax") and a factor on its
learning rate (``mod1_visible_lr_scale``, ``mod2_visible_lr_scale``).
Where both are Bernoulli the phase uses only what ``iDBN`` and
``iMDBN_BiModal`` have offered since the first benchmark; otherwise
set-up imports the program's non-Bernoulli units first thing, so a
program without them fails at once. The reference is
``reference/mdbn.py`` for every unit type.

The checks are the image cell's, taken over both stacks: from the start
(``check_steps`` steps in set-up) and one batch step of each stack from
the state the window left, through ``dbn_train.idbn_batch_step``
(``step_loss_gap.mod1``, ``.mod2``), with the lower quartiles over the
leaves ``grad_gap_q1`` and ``step_change_diff_q1``, and each stack's
worst layer-0 leaf of the step, ``step_layer0_diff.mod1`` and ``.mod2``.
The step runs ``step_cd`` CD steps (the traffic file's; the window's CD
where it names none): in these stacks a draw that rounding flips early
in a CD-10 chain turns its row into another sample of the chain often
enough that the step's loss reads the flip, not the arithmetic (PERF.md
§2), while at CD-1 a flipped draw moves only its layer and the layers
above it in its own stack. The quartiles pass over such a flip, and so
over any fault that stays in one layer; the layer-0 numbers read the
layer whose units are not Bernoulli, where one flipped draw moves the
leaves by a few hundredths at most and a wrong draw or mean by tenths."""

from __future__ import annotations

import gc
import statistics
from typing import Dict

import torch

from portbench import compare, counts, counts_mdbn, inputs
from portbench.drivers import train
from portbench.reference import keys
from portbench.reference import mdbn as ref_mdbn
from portbench.reference import rbm as ref_rbm

MODS = ("mod1", "mod2")
BERNOULLI = "bernoulli"


def _q1(gaps: Dict[str, float]) -> float:
    """The lower quartile of the leaves' gaps."""
    return statistics.quantiles(sorted(gaps.values()), n=4)[0]


def _merged(per: dict) -> dict:
    """Both stacks' numbers as one: the losses MOD1's then MOD2's, each
    leaf under its stack's name."""
    out = {"losses": [x for k in MODS for x in per[k]["losses"]]}
    for part in ("grads", "change"):
        if part in per[MODS[0]]:
            out[part] = {f"{k}.{n}": v for k in MODS
                         for n, v in per[k][part].items()}
    return out


class ModPhase(train._Phase):
    """Both modality iDBNs of ``iMDBN_BiModal``, every layer on every
    batch, CD-k through the fused half-steps; the joint is built but not
    trained."""

    span = "iDBN.train"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 dtype: str = None):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        m, t = cfg["model"], cfg["training"]
        self.sizes = {k: list(m[f"{k}_layers"]) for k in MODS}
        self.visible = {k: m.get(f"{k}_visible", BERNOULLI) for k in MODS}
        self.lr_scale = {k: float(m.get(f"{k}_visible_lr_scale", 1.0))
                         for k in MODS}
        self.plain = all(v == BERNOULLI for v in self.visible.values())
        self.batch = int(cfg["dataset"]["batch_size"])
        self.n = inputs.n_train(cfg)
        self.cd = int(t["cd"])
        # the CD steps of the one-batch step check: the window's, unless
        # the traffic file names fewer (``step_cd``)
        self.step_cd = int(traffic.get("step_cd", self.cd))
        self.dtype = dtype or t["dtype"]
        self.params = train.params(cfg, seed, dtype=self.dtype)
        if not self.plain:
            for k in MODS:
                self.params[f"{k.upper()}_VISIBLE"] = self.visible[k]
                self.params[f"{k.upper()}_VISIBLE_LR_SCALE"] = \
                    self.lr_scale[k]

    # -- inputs ----------------------------------------------------------------

    def _inputs(self):
        """(mod1 rows, mod2 rows) of the training split."""
        d = self.cfg["dataset"]
        if self.plain:
            v1, cls = inputs.dot_images(self.seed, self.n, d["side"],
                                        d["num_classes"], self.device)
            v2 = inputs.second_modality(self.seed, cls, self.sizes["mod2"][0],
                                        d["num_classes"], self.device)
            return v1, v2
        from portbench import inputs_mdbn
        return inputs_mdbn.features_and_tags(
            self.seed, self.n, self.sizes["mod1"][0], self.sizes["mod2"][0],
            d["num_classes"], self.device,
            max_words=int(d["max_words"]))

    # -- set-up ------------------------------------------------------------

    def setup(self) -> None:
        if not self.plain:
            # the program's non-Bernoulli visible units, first thing: a
            # program without them stops here, before any training
            from multimodal_idbn_tpu_torch.ops import fast_cd, rsoftmax
            fast_cd.fast_gaussian_cd_update, rsoftmax.rs_sample  # noqa
        from multimodal_idbn_tpu_torch.device import set_matmul_precision
        from multimodal_idbn_tpu_torch.models.imdbn_bimodal import \
            iMDBN_BiModal
        from multimodal_idbn_tpu_torch.ops.rbm_ops import RBMState
        cfg, dev = self.cfg, self.device
        set_matmul_precision(cfg["training"]["matmul_precision"])
        v1, v2 = self._inputs()
        self.data = {"mod1": v1, "mod2": v2}
        self.init = {"mod1": inputs.rbm_weights(self.seed, self.sizes["mod1"],
                                                dev),
                     "mod2": inputs.rbm_weights(self.seed, self.sizes["mod2"],
                                                dev, stream=11)}
        model = iMDBN_BiModal(
            self.sizes["mod1"], self.sizes["mod2"],
            list(cfg["model"]["joint_hidden"]), params=self.params,
            dataloader=train._Loader(self.batch), device=dev,
            seed=self.seed)
        self.dbns = {"mod1": model.mod1_dbn, "mod2": model.mod2_dbn}
        for k, dbn in self.dbns.items():
            dt = dbn.layers[0].state.w.dtype
            for layer, st in zip(dbn.layers, self.init[k]):
                layer.state = RBMState(**{f: st[f].to(dt)
                                          for f in train.FIELDS})
        self.model = model
        self.runners = {k: dbn._epoch_runner(self.data[k].clone(),
                                             self.batch)
                        for k, dbn in self.dbns.items()}
        steps = int(self.traffic["check_steps"])
        losses = {k: [] for k in MODS}
        for e in range(steps):
            for k in MODS:
                losses[k].append(self._epoch(k, e))
            if e == 0:
                grads = {k: train._host(self._leaves(k, ("w_m", "hb_m",
                                                         "vb_m")))
                         for k in MODS}
        observed = {}
        for k in MODS:
            after = self._leaves(k, ("w", "hb", "vb"))
            change = {n: v.float() - self.init[k][int(n[5:n.index(".")])][
                n.split(".")[1]] for n, v in after.items()}
            observed[k] = dict(losses=losses[k], grads=grads[k],
                               change=train._host(change))
        self.observed = _merged(observed)
        self.next_step = steps

    def _leaves(self, k: str, fields) -> Dict[str, torch.Tensor]:
        return {f"layer{i}.{f}": getattr(layer.state, f)
                for i, layer in enumerate(self.dbns[k].layers)
                for f in fields}

    # -- the window ----------------------------------------------------------

    def _epoch(self, k: str, epoch: int) -> float:
        dbn = self.dbns[k]
        loss = dbn._train_epoch(epoch, self.runners[k], self.batch)
        dbn.loss_history.append(loss)
        return loss

    def step(self, epoch: int) -> float:
        """One MOD1 epoch, then one MOD2 epoch, each through its iDBN's
        per-epoch entry; the sum of their mean losses."""
        return sum(self._epoch(k, epoch) for k in MODS)

    def flops_per_step(self) -> float:
        return sum(counts.image_epoch_flops(self.sizes[k], self.cd, self.n,
                                            self.batch) for k in MODS)

    def half_step_shapes(self):
        """(B, K, N) of every half-step launch of a step, MOD1's then
        MOD2's."""
        return [s for k in MODS for s in counts.image_half_steps(
            self.sizes[k], self.cd, self.n, self.batch)]

    def launch_schedule(self):
        """(half-step launches (entry, B, K, N), word draws (B, V)) of one
        step, MOD1's then MOD2's."""
        half, words = [], []
        for k in MODS:
            h, w = counts_mdbn.stack_launches(self.sizes[k], self.visible[k],
                                              self.cd, self.n, self.batch)
            half += h
            words += w
        return half, words

    def _next_batch(self):
        """(key, rows) of batch 0 of epoch ``next_step``: the same for
        both stacks, which share the model's seed."""
        ekey = keys.fold_in(self.seed, self.next_step)
        rows = keys.permutation(ekey, self.n)[:self.batch]
        return keys.fold_in(ekey, 0), rows.to(self.device)

    def _schedule(self, e: int):
        t = self.cfg["training"]
        return (train.lr_at(t["learning_rate"], e, t["learning_rate_dynamic"]),
                train.mom_at(t["init_momentum"], t["final_momentum"], e))

    def program_step(self) -> None:
        """The window's next batch through the program's exported batch
        step (``dbn_train.idbn_batch_step``, the body of its epochs) from
        the state the window left, for each stack."""
        from multimodal_idbn_tpu_torch.ops import dbn_train
        key, rows = self._next_batch()
        lr, mom = self._schedule(self.next_step)
        self.step_start, observed = {}, {}
        for k, dbn in self.dbns.items():
            kw = dbn._epoch_kw(self.batch)
            del kw["batch_size"]
            wd, sf = kw.pop("weight_decay"), kw.pop("sparsity_factor")
            kw["cd"] = self.step_cd
            before = dbn.states()
            self.step_start[k] = [{f: getattr(st, f).detach().float().cpu()
                                   .clone() for f in train.FIELDS}
                                  for st in before]
            after, losses = dbn_train.idbn_batch_step(
                before, key, self.data[k].index_select(0, rows), lr, mom,
                wd, sf, **kw)
            observed[k] = dict(
                losses=[float(x) for x in losses.float().cpu()],
                change=train._host({
                    f"layer{i}.{f}": getattr(st, f).float()
                    - self.step_start[k][i][f].to(self.device)
                    for i, st in enumerate(after) for f in ("w", "hb",
                                                            "vb")}))
        self.step_observed = _merged(observed)

    # -- the reference ---------------------------------------------------------

    def _ref_batch_step(self, ar, k, layers, key, v, lr, mom):
        return ref_mdbn.batch_step(
            ar, layers, key, v, lr=lr, mom=mom,
            wd=self.cfg["training"]["weight_penalty"], cd=self.step_cd,
            visible=self.visible[k], lr_scale=self.lr_scale[k])

    def _ref_epoch(self, ar, k, layers, e):
        lr, mom = self._schedule(e)
        return ref_mdbn.epoch(
            ar, layers, self.data[k], keys.fold_in(self.seed, e), lr=lr,
            mom=mom, wd=self.cfg["training"]["weight_penalty"], cd=self.cd,
            batch=self.batch, visible=self.visible[k],
            lr_scale=self.lr_scale[k])

    def reference(self, ar: ref_rbm.Arith) -> dict:
        """The first steps in the reference from the same inputs, each
        stack on its own."""
        out = {}
        for k in MODS:
            layers = [ref_rbm.clone(st) for st in self.init[k]]
            losses = []
            for e in range(int(self.traffic["check_steps"])):
                layers, loss = self._ref_epoch(ar, k, layers, e)
                losses.append(loss)
                if e == 0:
                    grads = train._host({f"layer{i}.{f}": st[f]
                                         for i, st in enumerate(layers)
                                         for f in ("w_m", "hb_m", "vb_m")})
            change = {f"layer{i}.{f}": st[f] - self.init[k][i][f]
                      for i, st in enumerate(layers)
                      for f in ("w", "hb", "vb")}
            out[k] = dict(losses=losses, grads=grads,
                          change=train._host(change))
        return _merged(out)

    def step_reference(self, ar: ref_rbm.Arith) -> dict:
        """The one batch step of each stack in the reference, from the
        same state."""
        key, rows = self._next_batch()
        lr, mom = self._schedule(self.next_step)
        out = {}
        for k in MODS:
            start = [{f: v.to(self.device) for f, v in st.items()}
                     for st in self.step_start[k]]
            layers, losses = self._ref_batch_step(
                ar, k, [ref_rbm.clone(st) for st in start], key,
                self.data[k].index_select(0, rows), lr, mom)
            out[k] = dict(losses=losses, change=train._host(
                {f"layer{i}.{f}": st[f] - start[i][f]
                 for i, st in enumerate(layers) for f in ("w", "hb", "vb")}))
        return _merged(out)

    # -- the numbers -------------------------------------------------------------

    def _numbers(self, prog: dict, ref: dict, prog_step: dict,
                 ref_step: dict) -> Dict[str, float]:
        """The image cell's numbers over both stacks, then the lower
        quartiles over the leaves: ``grad_gap_q1`` of the first step's
        gradients, ``step_change_diff_q1`` of the one-batch step's change
        (‖program change − reference change‖ against max(the leaf's
        reference norm, the median leaf's)); and of each stack
        ``step_loss_gap`` and ``step_layer0_diff``, the worst of its
        layer-0 leaves of that change, each against the larger of its
        reference norm and the median of the layer's own leaves (the
        Gaussian layer learns at a hundredth of the others' rate). A draw that rounding flips moves
        the leaves of its own layer and of the layers above it in its
        stack (the worst and the median leaf read it); a fault of
        precision or of the batch moves both stacks, and so the quartile;
        a fault in one stack's bottom layer moves that stack's layer-0
        leaves."""
        out = compare.training_numbers(prog, ref)
        out["grad_gap_q1"] = _q1(compare.leaf_gaps(
            prog["grads"], ref["grads"], compare.kept_leaves(ref["grads"])))
        out.update(compare.step_numbers(prog_step, ref_step))
        diff = compare.diff_gaps(prog_step["change"], ref_step["change"],
                                 compare.kept_leaves(ref_step["change"]))
        out["step_change_diff_q1"] = _q1(diff)
        at = 0
        for k in MODS:
            n = len(self.sizes[k]) - 1
            out[f"step_loss_gap.{k}"] = compare.loss_gap(
                prog_step["losses"][at:at + n], ref_step["losses"][at:at + n])
            out[f"step_layer0_diff.{k}"] = max(compare.diff_gaps(
                prog_step["change"], ref_step["change"],
                [leaf for leaf in diff
                 if leaf.startswith(f"{k}.layer0.")]).values())
            at += n
        return out

    def numbers(self) -> Dict[str, float]:
        return self._numbers(self.observed, self.fp32_reference(),
                             self.step_observed, self.fp32_step())

    def control_numbers(self, ar: ref_rbm.Arith) -> Dict[str, float]:
        return self._numbers(self.reference(ar), self.fp32_reference(),
                             self.step_reference(ar), self.fp32_step())

    def free(self) -> None:
        del self.model, self.runners, self.dbns
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


PHASES = {"mod": ModPhase}


class Driver(train.Driver):
    """A modality cell: the phase named by the traffic file."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, spans,
                 **phase_kw):
        self.phase = PHASES[traffic["phase"]](cfg, traffic, seed, device,
                                              **phase_kw)
        self.traffic = traffic
        self.spans = spans

