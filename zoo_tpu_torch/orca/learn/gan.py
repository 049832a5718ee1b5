"""GANEstimator: alternating discriminator and generator training
(counterpart of ``zoo_tpu/orca/learn/gan.py``).

One Python step is one adversarial iteration, as the JAX package's one
jitted step is: ``d_steps`` discriminator updates, then ``g_steps``
generator updates, each on fresh noise. The key chain is the JAX
step's: ``PRNGKey(seed + 2)``, ``rng, zk = split(rng)`` before every
sub-step (a device launch of the key kernel on the card), the noise
``normal(zk, (batch, noise_dim))`` from :mod:`zoo_tpu_torch.ops.random`
(JAX's within 3 ulp). Gradients reach the trainable subtrees only;
BatchNorm layers normalize with the batch's moments and their running
stats stay fixed, as in JAX.

With a training guard (by default one from ``ZOO_GUARD_*``), the whole
iteration is one unit: its state (both nets' params and both
optimizers' states) is kept before it, and where the health predicate
over the summed losses and the last sub-steps' gradients is false the
iteration's writes are folded back on the device, bit for bit, and its
losses count 0. The guard's counters are read once an epoch. The
epoch's order is ``RandomState(seed + epoch).permutation`` with the
ragged tail dropped.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from zoo_tpu_torch.pipeline.api.keras.engine.base import (
    tree_leaves,
    tree_map,
)


def _bce_logits(logits, target: float):
    z = logits.reshape(-1)
    # stable sigmoid BCE against a constant target
    return torch.mean(torch.clamp_min(z, 0) - z * target
                      + torch.log1p(torch.exp(-torch.abs(z))))


def _fold_in_place(ok, tree, old) -> None:
    """Each tensor of ``tree`` keeps its new bits where ``ok`` and takes
    back ``old``'s where not: one ``where`` into the tensor itself."""
    for t, o in zip(tree_leaves(tree), tree_leaves(old)):
        torch.where(ok, t, o, out=t)


class GANEstimator:
    """``generator``: a KerasNet from noise to a sample; ``discriminator``:
    a KerasNet from a sample to a logit (linear output). Optimizers are
    the port's (names or instances)."""

    def __init__(self, generator, discriminator,
                 g_optimizer="adam", d_optimizer="adam",
                 noise_dim: int = 64, d_steps: int = 1, g_steps: int = 1,
                 guard=None, device=None):
        from zoo_tpu_torch.orca.learn.guard import TrainingGuard
        from zoo_tpu_torch.pipeline.api.keras.optimizers import (
            get_optimizer,
        )

        self.g = generator
        self.d = discriminator
        self.g_tx = get_optimizer(g_optimizer)
        self.d_tx = get_optimizer(d_optimizer)
        self.noise_dim = int(noise_dim)
        self.d_steps = int(d_steps)
        self.g_steps = int(g_steps)
        self.device = device
        self._state = None
        # adversarial training is the classic NaN factory (saturated
        # discriminators); a bad iteration folds away whole. No
        # checkpoint manager here, so divergence escalates straight to
        # TrainingDiverged.
        if guard is False:
            self._guard = None
        else:
            self._guard = guard if guard is not None \
                else TrainingGuard.from_env(name="gan")

    # -- one adversarial iteration ----------------------------------------
    def _forward(self, net, trainable, state, x):
        from zoo_tpu_torch.pipeline.api.keras.engine.topology import (
            _merge_state,
        )
        return net._forward(_merge_state(trainable, state), [x],
                            training=True, rng=None, collect=None)

    def _noise(self, rng, n):
        from zoo_tpu_torch.ops import random as R
        from zoo_tpu_torch.ops.kernels import dropout as D
        keys = D.split(rng)
        return keys[0], R.normal(keys[1], (n, self.noise_dim))

    def _step(self, rng, real, guard, gstate):
        """One iteration on ``real`` (a device batch), in place on the
        state. Returns ``(rng, d_loss, g_loss, gstate)``, the losses
        detached device scalars (0 where the guard skipped)."""
        g_tr, g_st, d_tr, d_st, g_opt, d_opt = self._state
        old = None
        if guard is not None:
            old = tree_map(lambda t: t.detach().clone(),
                           {"g": g_tr, "d": d_tr, "go": g_opt, "do": d_opt})
        d_loss = g_loss = torch.zeros((), device=real.device)
        d_grads = g_grads = []
        n = real.shape[0]
        for _ in range(self.d_steps):
            rng, z = self._noise(rng, n)
            with torch.no_grad():
                fake = self._forward(self.g, g_tr, g_st, z)
            with torch.enable_grad():
                real_logit = self._forward(self.d, d_tr, d_st, real)
                fake_logit = self._forward(self.d, d_tr, d_st, fake)
                loss = _bce_logits(real_logit, 1.0) + \
                    _bce_logits(fake_logit, 0.0)
            d_grads = list(torch.autograd.grad(
                loss, tree_leaves(d_tr), allow_unused=True,
                materialize_grads=True))
            it = iter(d_grads)
            _, d_opt = self.d_tx.apply(tree_map(lambda _: next(it), d_tr),
                                       d_opt, d_tr)
            d_loss = loss.detach()
        for _ in range(self.g_steps):
            rng, z = self._noise(rng, n)
            with torch.enable_grad():
                fake = self._forward(self.g, g_tr, g_st, z)
                # the non-saturating generator loss
                loss = _bce_logits(self._forward(self.d, d_tr, d_st, fake),
                                   1.0)
            g_grads = list(torch.autograd.grad(
                loss, tree_leaves(g_tr), allow_unused=True,
                materialize_grads=True))
            it = iter(g_grads)
            _, g_opt = self.g_tx.apply(tree_map(lambda _: next(it), g_tr),
                                       g_opt, g_tr)
            g_loss = loss.detach()
        if guard is not None:
            # one non-finite sub-loss or gradient poisons the whole
            # iteration: fold it away as a unit
            ok = guard.grad_norm_ok(d_loss + g_loss,
                                    grads=d_grads + g_grads)
            with torch.no_grad():
                _fold_in_place(ok, {"g": g_tr, "d": d_tr, "go": g_opt,
                                    "do": d_opt}, old)
            gstate = guard.gstate_update(gstate, ok)
            zero = torch.zeros_like(d_loss)
            d_loss = torch.where(ok, d_loss, zero)
            g_loss = torch.where(ok, g_loss, zero)
        self._state = (g_tr, g_st, d_tr, d_st, g_opt, d_opt)
        return rng, d_loss, g_loss, gstate

    # -- API ---------------------------------------------------------------
    def fit(self, data, epochs: int = 1, batch_size: int = 32,
            seed: int = 0) -> Dict[str, list]:
        """Train on ``data`` (an array of real samples, or ``{"x": ...}``)
        on ``device`` (default: the runtime context's, else the current
        CUDA device); returns ``{"d_loss", "g_loss"}`` per-epoch means
        over the iterations the guard kept."""
        from zoo_tpu_torch.ops.random import PRNGKey
        from zoo_tpu_torch.pipeline.api.keras.engine.topology import (
            _merge_state,
            _placed,
            _split_state,
        )

        real = np.asarray(data["x"] if isinstance(data, dict) else data,
                          np.float32)
        dev = _placed(self.device)
        self.g.build(torch.Generator(device=dev).manual_seed(int(seed)),
                     [(None, self.noise_dim)])
        self.d.build(torch.Generator(device=dev).manual_seed(int(seed) + 1),
                     [(None,) + real.shape[1:]])
        if batch_size > len(real):
            raise ValueError(f"batch_size ({batch_size}) exceeds dataset "
                             f"size ({len(real)})")
        if self._state is None:
            self.g._place_params(self.g.params, dev)
            self.d._place_params(self.d.params, dev)
            g_tr, g_st = _split_state(self.g.params)
            d_tr, d_st = _split_state(self.d.params)
            self._state = (g_tr, g_st, d_tr, d_st, self.g_tx.init(g_tr),
                           self.d_tx.init(d_tr))
        rng = PRNGKey(int(seed) + 2, dev)
        n = (len(real) // batch_size) * batch_size
        history = {"d_loss": [], "g_loss": []}
        guard = self._guard if (self._guard is not None
                                and self._guard.active) else None
        gstate = None
        if guard is not None:
            guard.begin_fit()
            guard.install_signal_handler()
            gstate = guard.device_init(dev)
        bad_seen = 0
        try:
            for epoch in range(epochs):
                # permute the full set, then drop the ragged tail:
                # different rows fall off each epoch
                perm = np.random.RandomState(seed + epoch).permutation(
                    len(real))[:n]
                d_sum = g_sum = None
                steps = 0
                for lo in range(0, n, batch_size):
                    batch = torch.from_numpy(
                        real[perm[lo:lo + batch_size]]).to(dev)
                    rng, d_loss, g_loss, gstate = self._step(
                        rng, batch, guard, gstate)
                    d_sum = d_loss if d_sum is None else d_sum + d_loss
                    g_sum = g_loss if g_sum is None else g_sum + g_loss
                    steps += 1
                good = steps
                if guard is not None:
                    bad, streak = int(gstate["bad"]), int(gstate["streak"])
                    act = guard.on_boundary(
                        bad_total=bad, streak=streak,
                        window_loss=float(d_sum + g_sum),
                        window_steps=steps,
                        global_step=(epoch + 1) * steps, epoch=epoch)
                    good = max(steps - (bad - bad_seen), 1)
                    bad_seen = bad
                    if act == "rollback":
                        # no checkpoint manager on the GAN path: this
                        # raises TrainingDiverged unless the caller bound
                        # restore/save callbacks on the guard
                        state, _aux, _lr = guard.rollback()
                        self._state = state["gan_state"]
                        gstate = guard.device_init(dev)
                        bad_seen = 0
                        continue
                    if act == "preempt":
                        guard.preempt_checkpoint(step=(epoch + 1) * steps)
                history["d_loss"].append(float(d_sum) / good)
                history["g_loss"].append(float(g_sum) / good)
        finally:
            if guard is not None:
                guard.uninstall_signal_handler()
        g_tr, g_st, d_tr, d_st = self._state[:4]
        self.g.params = _merge_state(g_tr, g_st)
        self.d.params = _merge_state(d_tr, d_st)
        return history

    def generate(self, n: int, seed: int = 0):
        """``n`` samples from ``normal(PRNGKey(seed), (n, noise_dim))``
        through the generator's inference forward, as numpy."""
        from zoo_tpu_torch.ops.random import PRNGKey, normal
        from zoo_tpu_torch.pipeline.api.keras.engine.topology import _placed
        dev = self.g._params_device() if self.g.params is not None \
            else _placed(self.device)
        z = normal(PRNGKey(int(seed), dev), (n, self.noise_dim))
        return self.g.predict(z.cpu().numpy(), batch_size=n, device=dev)
