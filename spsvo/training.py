"""SuperPoint training on device: loss, update step, and mesh-sharded variants.

The reference treats training as external (backbones retrained on MS-COCO in
eric-yyjau/pytorch-superpoint; report Table 2 shows the training cost of each
backbone). This framework makes retraining a first-class capability so the 6
backbone families can be (re)trained natively on device:

  * detector loss: per-cell 65-way cross-entropy against cell-grid labels
    (the 65th "dustbin" channel = no-keypoint cell), exactly the SuperPoint
    paper's formulation that produces logits compatible with the pipeline's
    `cell_softmax` postprocess;
  * descriptor loss: hinge contrastive loss between a frame and a
    homography-warped copy (positive pairs = cells mapping onto each other);
  * data parallel over a `Mesh(("data",))`: batch sharded, gradients
    all-reduced by XLA from the sharding annotations alone (no explicit
    collectives — the compiler inserts psums over ICI).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P



class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: jax.Array


def detector_loss(det_logits: jax.Array, cell_labels: jax.Array) -> jax.Array:
    """det_logits: (B, Hc, Wc, 65); cell_labels: (B, Hc, Wc) int32 in [0, 64]
    (64 = dustbin/no keypoint)."""
    logp = jax.nn.log_softmax(det_logits, axis=-1)
    nll = -jnp.take_along_axis(logp, cell_labels[..., None], axis=-1)[..., 0]
    return jnp.mean(nll)


def descriptor_loss(desc_a: jax.Array, desc_b: jax.Array,
                    correspondence: jax.Array, pos_margin: float = 1.0,
                    neg_margin: float = 0.2, lambda_d: float = 250.0
                    ) -> jax.Array:
    """Hinge contrastive loss over cell-grid descriptor pairs.

    desc_a/b: (B, Hc, Wc, D) L2-normalised; correspondence: (B, Hc*Wc, Hc*Wc)
    binary, 1 where cell i of A maps onto cell j of B under the homography.
    """
    b, hc, wc, d = desc_a.shape
    da = desc_a.reshape(b, hc * wc, d)
    db = desc_b.reshape(b, hc * wc, d)
    sim = jnp.einsum("bid,bjd->bij", da, db,
                     preferred_element_type=jnp.float32)
    pos = jnp.maximum(0.0, pos_margin - sim)
    neg = jnp.maximum(0.0, sim - neg_margin)
    loss = correspondence * lambda_d * pos + (1.0 - correspondence) * neg
    return jnp.mean(loss)


def total_loss(apply_fn, params, batch: Dict[str, jax.Array]
               ) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    out_a = apply_fn(params, batch["image_a"])
    out_b = apply_fn(params, batch["image_b"])
    l_det = (detector_loss(out_a["output_det"], batch["labels_a"])
             + detector_loss(out_b["output_det"], batch["labels_b"]))
    l_desc = descriptor_loss(out_a["output_desc"], out_b["output_desc"],
                             batch["correspondence"])
    loss = l_det + l_desc
    return loss, {"loss": loss, "det_loss": l_det, "desc_loss": l_desc}


def _is_buffer(name: str) -> bool:
    """BatchNorm statistics are inference buffers, not weights — training
    them as free parameters drives running_var negative (NaN through
    rsqrt). They are frozen via an optax mask."""
    return name.endswith(".running_mean") or name.endswith(".running_var")


def make_optimizer(lr: float, params: Any) -> optax.GradientTransformation:
    labels = jax.tree.map_with_path(
        lambda path, _: ("buffer" if _is_buffer(
            str(path[-1].key) if path else "") else "weight"),
        params)
    return optax.multi_transform(
        {"weight": optax.adam(lr), "buffer": optax.set_to_zero()}, labels)


def init_train_state(apply_fn, params, lr: float = 1e-3) -> TrainState:
    tx = make_optimizer(lr, params)
    return TrainState(params=params, opt_state=tx.init(params),
                      step=jnp.int32(0))


def train_step(state: TrainState, batch: Dict[str, jax.Array], *, apply_fn,
               lr: float = 1e-3) -> Tuple[TrainState, Dict[str, jax.Array]]:
    tx = make_optimizer(lr, state.params)
    grad_fn = jax.value_and_grad(
        lambda p: total_loss(apply_fn, p, batch), has_aux=True)
    (_, metrics), grads = grad_fn(state.params)
    updates, opt_state = tx.update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)
    return TrainState(params, opt_state, state.step + 1), metrics


def build_sharded_train_step(apply_fn, mesh: Mesh, lr: float = 1e-3,
                             axis_name: str = "data"):
    """jit the train step with batch sharded over the mesh and params
    replicated; XLA inserts the gradient all-reduce over ICI."""
    batch_sharding = NamedSharding(mesh, P(axis_name))
    replicated = NamedSharding(mesh, P())
    step = functools.partial(train_step, apply_fn=apply_fn, lr=lr)
    return jax.jit(
        step,
        in_shardings=(replicated,
                      {"image_a": batch_sharding, "image_b": batch_sharding,
                       "labels_a": batch_sharding, "labels_b": batch_sharding,
                       "correspondence": batch_sharding}),
        out_shardings=(replicated, replicated))


def synthetic_batch(key: jax.Array, batch: int, h: int, w: int
                    ) -> Dict[str, jax.Array]:
    """Random-label training batch (homographic-adaptation data pipeline is
    layered on in io/; this feeds compile checks and the multi-chip dryrun)."""
    hc, wc = h // 8, w // 8
    k1, k2, k3, k4 = jax.random.split(key, 4)
    eye = jnp.eye(hc * wc, dtype=jnp.float32)[None]
    return {
        "image_a": jax.random.uniform(k1, (batch, h, w, 1)),
        "image_b": jax.random.uniform(k2, (batch, h, w, 1)),
        "labels_a": jax.random.randint(k3, (batch, hc, wc), 0, 65),
        "labels_b": jax.random.randint(k4, (batch, hc, wc), 0, 65),
        "correspondence": jnp.tile(eye, (batch, 1, 1)),
    }
