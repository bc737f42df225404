"""Optimizers with the reference's weight-decay parameter split.

Reference main.py:333-353: params whose tensor is rank<2 or named
bias / ln / bn / logit_scale get no weight decay; everything else does.
Implemented as an optax mask over the param tree.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import jax
import optax


def _no_decay(path: tuple, value) -> bool:
    names = {getattr(p, "key", str(p)) for p in path}
    if value.ndim < 2:
        return True
    if "bias" in names or "scale" in names:  # flax LayerNorm scale == ln gain
        return True
    return False


def decay_mask(params) -> Any:
    return jax.tree_util.tree_map_with_path(
        lambda path, v: not _no_decay(path, v), params
    )


def adamw(
    learning_rate: Callable | float,
    beta1: float = 0.9,
    beta2: float = 0.98,
    eps: float = 1e-6,
    weight_decay: float = 0.2,
    max_grad_norm: float | None = None,
    mu_dtype=None,
) -> optax.GradientTransformation:
    """AdamW with CLIP defaults (reference params.py get_default_params:
    ViT models use beta2=0.98, eps=1e-6) and masked weight decay.

    mu_dtype=jnp.bfloat16 halves the first-moment memory — useful on a single
    device where the fp32 optimizer state dominates memory; on a mesh the state is
    sharded over the data axis anyway."""
    tx = optax.adamw(
        learning_rate=learning_rate,
        b1=beta1,
        b2=beta2,
        eps=eps,
        weight_decay=weight_decay,
        mask=decay_mask,
        mu_dtype=mu_dtype,
    )
    if max_grad_norm is not None:
        tx = optax.chain(optax.clip_by_global_norm(max_grad_norm), tx)
    return tx


def adam(learning_rate: Callable | float = 1e-4) -> optax.GradientTransformation:
    """Plain Adam — the PACL/SPARC trainer's optimizer (train_pacl.py:107)."""
    return optax.adam(learning_rate)


def build_optimizer(name: str, **kw) -> optax.GradientTransformation:
    if name == "adamw":
        return adamw(**kw)
    if name == "adam":
        return adam(**kw)
    raise KeyError(f"unknown optimizer {name!r}")
