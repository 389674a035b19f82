"""The training step of either stage; counterpart of the ``loss_fn`` and
``one_step`` of ``nunerf_tpu/train/trainer.py:_build_train_step``
(reference ``train/trainer.py:152-170``).

One step: ``renderer.train_outputs`` -> ``compute_losses`` -> backward ->
one Adam update with optax.adam's constants (b1 0.9, b2 0.999, eps 1e-8) of
the parameters that require grad.  A ``Stage2Renderer`` holds its stage-1
weights with ``requires_grad_(False)``: they get no optimizer state and no
update, the counterpart of ``optax.multi_transform`` with ``set_to_zero`` on
the ``frozen`` subtree (``train/trainer.py:175-181``).  The batch is already
on the renderer's device; ray selection, validation, checkpoints and the
training loop are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

from nunerf_tpu_torch.train.loss import compute_losses


class TrainStep:
    """Owns the optimizer of ``renderer``'s parameters.

    ``lr`` is a constant or a schedule ``optimizer step -> lr`` evaluated at
    the number of updates taken so far, as optax evaluates its schedules."""

    def __init__(self, renderer, lr: Union[float, Callable[[int], float]] = 5e-4):
        self.renderer = renderer
        self.lr = lr
        self.params = [p for p in renderer.parameters() if p.requires_grad]
        self.optimizer = torch.optim.Adam(self.params, lr=self._lr(0),
                                          betas=(0.9, 0.999), eps=1e-8)
        self.n_updates = 0

    def _lr(self, count: int) -> float:
        return self.lr(count) if callable(self.lr) else float(self.lr)

    def loss_fn(self, batch, step: int, generator: Optional[torch.Generator] = None):
        outputs = self.renderer.train_outputs(batch, step, generator)
        terms = compute_losses(outputs, batch, step, self.renderer.cfg)
        return terms["loss_total"], terms

    def compute_grads(self, batch, step: int, generator=None):
        """Loss terms after filling every parameter's ``.grad`` (zeros where
        the loss does not reach a parameter, as ``jax.grad`` gives)."""
        self.optimizer.zero_grad(set_to_none=False)
        loss, terms = self.loss_fn(batch, step, generator)
        loss.backward()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return terms

    def apply(self):
        for group in self.optimizer.param_groups:
            group["lr"] = self._lr(self.n_updates)
        self.optimizer.step()
        self.n_updates += 1

    def __call__(self, batch, step: int, generator=None) -> Dict[str, torch.Tensor]:
        """One training step; returns the detached loss terms."""
        terms = self.compute_grads(batch, step, generator)
        self.apply()
        return {k: v.detach() if torch.is_tensor(v) else v for k, v in terms.items()}
