"""Multi-device dry runs on the 8-device virtual CPU mesh (conftest.py).

Each test jits and runs one sharded step over a (data=4 x model=2) mesh and
checks it against the unsharded result or for finiteness: the contrastive
train step with global-batch negatives, the SigLIP ppermute ring, GradCache,
FSDP, and tensor-parallel LLaVA, VLM2Vec and CLIP-FlanT5. The same code runs
on four GPUs through ``chip_smoke.py --multi``.
"""

import jax
import numpy as np
import pytest

from clip_embeds.parallel.mesh import create_mesh


@pytest.fixture(scope="module")
def mesh():
    return create_mesh(4, 2, devices=jax.devices()[:8])


def _tiny_clip():
    from clip_embeds.core.factory import create_model

    return create_model("test-tiny")


def test_train_step_dp_tp(mesh, capfd):
    """One contrastive train step on tiny shapes: batch sharded over 'data',
    block weights Megatron-sharded over 'model' (parallel/sharding_rules.py),
    global-batch negatives through XLA-inserted all-gathers, Adam moments
    ZeRO-1-sharded over 'data'."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from clip_embeds.data.synthetic import synthetic_batches
    from clip_embeds.parallel.sharding_rules import (
        clip_param_specs,
        zero1_opt_state_sharding,
    )
    from clip_embeds.train.optim import adamw
    from clip_embeds.train.steps import TrainState, make_clip_train_step

    n_data = mesh.devices.shape[0]
    model, params = _tiny_clip()
    specs = clip_param_specs(params)
    params = jax.tree.map(
        lambda x, s: jax.device_put(jnp.asarray(x), NamedSharding(mesh, s)),
        params, specs,
    )

    state = TrainState.create(params, adamw(1e-4))
    # ZeRO-1: shard the Adam moments over the data axis
    state = state.replace(
        opt_state=zero1_opt_state_sharding(mesh, state.opt_state)
    )
    step = jax.jit(make_clip_train_step(model), donate_argnums=0)

    batch = next(synthetic_batches(
        batch_size=2 * n_data, image_size=32, context_length=77, num_batches=1,
    ))
    batch_sharding = NamedSharding(mesh, P("data"))
    batch = jax.tree.map(
        lambda x: jax.device_put(x, batch_sharding), batch
    )

    with jax.sharding.set_mesh(mesh):
        state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), f"non-finite loss {loss}"
    # SPMD partitioner warnings mean an inefficient layout for attention
    # intermediates under the Megatron specs (models/layers.py constraints)
    assert "Involuntary full rematerialization" not in capfd.readouterr().err


def test_siglip_ring(mesh):
    """SigLIP sigmoid loss with ppermute ring negatives: value + grad."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from clip_embeds.losses.siglip import siglip_loss, siglip_loss_ring

    rng = np.random.default_rng(0)
    b, d = 4 * mesh.devices.shape[0], 16

    def unit(x):
        x = jnp.asarray(x, jnp.float32)
        return x / jnp.linalg.norm(x, axis=-1, keepdims=True)

    shard = NamedSharding(mesh, P("data"))
    imgf = jax.device_put(unit(rng.normal(size=(b, d))), shard)
    txtf = jax.device_put(unit(rng.normal(size=(b, d))), shard)
    scale = jnp.asarray(10.0)
    bias = jnp.asarray(-10.0)

    def ring(t):
        return siglip_loss_ring(imgf, t, scale, bias, mesh)

    loss_ring, grad_ring = jax.jit(jax.value_and_grad(ring))(txtf)
    loss_global = jax.jit(
        lambda t: siglip_loss(imgf, t, scale, bias)
    )(txtf)
    np.testing.assert_allclose(
        float(loss_ring), float(loss_global), rtol=1e-5
    )
    assert np.isfinite(np.asarray(grad_ring)).all()


def test_grad_cache(mesh):
    """GradCache (scan encode -> rep grad -> vjp re-forward) on the mesh."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from clip_embeds.losses.clip_loss import clip_loss
    from clip_embeds.train.grad_cache import cache_grad_step

    model, params = _tiny_clip()

    rng = np.random.default_rng(1)
    n_data = mesh.devices.shape[0]
    b = 4 * n_data
    batch = {
        "images": jnp.asarray(
            rng.normal(size=(b, 32, 32, 3)), jnp.float32
        ),
        "texts": jnp.asarray(
            rng.integers(1, 100, size=(b, 77)), jnp.int32
        ),
    }
    batch = jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P("data"))), batch
    )

    def encode(p, chunk):
        out = model.apply({"params": p}, chunk["images"], chunk["texts"])
        return {"img": out["image_features"], "txt": out["text_features"]}

    def rep_loss(reps):
        return clip_loss(reps["img"], reps["txt"], jnp.asarray(10.0))

    @jax.jit
    def gc_step(p, batch):
        return cache_grad_step(encode, rep_loss, p, batch, n_chunks=2)

    with jax.sharding.set_mesh(mesh):
        loss, grads = gc_step(params, batch)
    assert np.isfinite(float(loss))
    gnorm = float(
        jnp.sqrt(sum(jnp.vdot(g, g) for g in jax.tree.leaves(grads))).real
    )
    assert np.isfinite(gnorm) and gnorm > 0


def test_fsdp(mesh):
    """FSDP (fully-sharded params over 'data') one train step: params stay
    sharded through the update, loss finite."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from clip_embeds.data.synthetic import synthetic_batches
    from clip_embeds.parallel.sharding_rules import fsdp_shard_params
    from clip_embeds.train.optim import adamw
    from clip_embeds.train.steps import TrainState, make_clip_train_step

    n_data = mesh.devices.shape[0]
    model, params = _tiny_clip()
    sharded = fsdp_shard_params(mesh, params, min_size=64)
    state = TrainState.create(sharded, adamw(1e-4))
    step = jax.jit(make_clip_train_step(model), donate_argnums=0)
    batch = next(synthetic_batches(
        batch_size=2 * n_data, image_size=32, context_length=77,
        num_batches=1,
    ))
    bs = NamedSharding(mesh, P("data"))
    batch = jax.tree.map(lambda x: jax.device_put(x, bs), batch)
    with jax.sharding.set_mesh(mesh):
        state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), f"non-finite FSDP loss {loss}"
    leaf = state.params["visual"]["transformer"]["resblocks_0"]["mlp"][
        "c_fc"]["kernel"]
    assert not leaf.sharding.is_fully_replicated, "FSDP leaf regathered"


def test_llava_tp(mesh):
    """TP-sharded LLaVA (Llama trunk, the VQAScore/VLM2Vec half of the
    stack): Megatron specs shard qkv/gate/up by column and o/down by row
    over 'model' (parallel/sharding_rules.py); the sharded VQA forward must
    equal the replicated one."""
    import jax.numpy as jnp

    from clip_embeds.core.config import VisionConfig
    from clip_embeds.models.llama import LlamaConfig
    from clip_embeds.models.llava import Llava, LlavaConfig
    from clip_embeds.parallel.sharding_rules import shard_params

    n_model = mesh.devices.shape[1]
    cfg = LlavaConfig(
        llama=LlamaConfig(
            vocab_size=256, hidden_size=64, intermediate_size=64 * n_model,
            num_layers=2, num_heads=4 * n_model,
            num_kv_heads=max(2, n_model), max_position_embeddings=128,
        ),
        vision=VisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                            head_width=32),
    )
    model = Llava(cfg, attn_impl="reference")
    rng = np.random.default_rng(2)
    ids = jnp.asarray([[1, 7, -200, 9, 11, 13]], jnp.int32)
    pixels = jnp.asarray(rng.standard_normal((1, 32, 32, 3)), jnp.float32)
    params = model.init(jax.random.PRNGKey(0), ids, pixels)["params"]
    want = np.asarray(
        model.apply({"params": params}, ids, pixels), np.float32)
    sharded = shard_params(mesh, params)
    with mesh:
        got = np.asarray(jax.jit(
            lambda p, i, px: model.apply({"params": p}, i, px)
        )(sharded, ids, pixels), np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    kern = sharded["language_model"]["model"]["layers_0"]["self_attn"][
        "q_proj"]["kernel"]
    assert not kern.sharding.is_fully_replicated, "TP leaf regathered"


def test_vlm2vec_grad_cache(mesh):
    """VLM2Vec GradCache train step (frozen TP-sharded LLaVA trunk + LoRA,
    contrastive over global-batch negatives) on the mesh; loss must match
    the unsharded plain step (grad-cache exactness + collective correctness
    in one check)."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from clip_embeds.core.config import VisionConfig
    from clip_embeds.models.llama import LlamaConfig
    from clip_embeds.models.llava import Llava, LlavaConfig
    from clip_embeds.models.lora import init_lora
    from clip_embeds.parallel.sharding_rules import shard_params
    from clip_embeds.train.optim import adamw
    from clip_embeds.train.steps import TrainState
    from clip_embeds.train.vlm2vec import make_vlm2vec_train_step

    cfg = LlavaConfig(
        llama=LlamaConfig(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, max_position_embeddings=256,
        ),
        vision=VisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                            head_width=32),
    )
    model = Llava(cfg, attn_impl="reference")
    ids0 = jnp.asarray([[1, 2, -200, 3]], jnp.int32)
    base = model.init(jax.random.PRNGKey(0), ids0,
                      jnp.zeros((1, 32, 32, 3)))["params"]
    lora = init_lora(base, rank=2, rng=jax.random.PRNGKey(1))

    rng = np.random.default_rng(0)
    n, length = 2 * mesh.devices.shape[0], 16
    qry_ids = np.full((n, length), 0, np.int32)
    qry_mask = np.zeros((n, length), bool)
    tgt_ids = np.full((n, length), 0, np.int32)
    tgt_mask = np.zeros((n, length), bool)
    for i in range(n):
        L = int(rng.integers(6, length))
        qry_ids[i, :L] = rng.integers(1, 250, L)
        qry_ids[i, 2] = -200
        qry_mask[i, :L] = True
        Lt = int(rng.integers(4, length))
        tgt_ids[i, :Lt] = rng.integers(1, 250, Lt)
        tgt_mask[i, :Lt] = True
    batch = {
        "qry_ids": qry_ids, "qry_mask": qry_mask,
        "qry_pixels": rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
        "tgt_ids": tgt_ids, "tgt_mask": tgt_mask,
    }

    # unsharded no-grad-cache reference loss
    s0 = TrainState.create(lora, adamw(0.0, weight_decay=0.0))
    _, m_ref = jax.jit(make_vlm2vec_train_step(model, base))(s0, batch)

    sharded_base = shard_params(mesh, base)
    step = make_vlm2vec_train_step(model, sharded_base,
                                   grad_cache_chunks=2)
    batch_sharded = {
        k: jax.device_put(v, NamedSharding(mesh, P("data")))
        for k, v in batch.items()
    }
    s1 = TrainState.create(
        jax.device_put(lora, NamedSharding(mesh, P())),
        adamw(0.0, weight_decay=0.0),
    )
    with mesh:
        s1, m_mesh = jax.jit(step)(s1, batch_sharded)
    loss, ref = float(m_mesh["loss"]), float(m_ref["loss"])
    np.testing.assert_allclose(loss, ref, rtol=2e-5)
    assert int(s1.step) == 1

    # unmaterialized-adapter leg: the QLoRA-shaped step (frozen trunk +
    # 'lora'-collection side-path, models/quant.py _lora_delta) over the
    # SAME TP-sharded base must equal the materialize() step with the same
    # NONZERO adapters (b=0 init would make the check trivial)
    lora_nz = {k: {"a": v["a"], "b": v["b"] + 0.05} for k, v in lora.items()}
    s0nz = TrainState.create(lora_nz, adamw(0.0, weight_decay=0.0))
    _, m_ref_nz = jax.jit(make_vlm2vec_train_step(model, base))(s0nz, batch)
    lmodel = Llava(cfg, attn_impl="reference", lora_rank=2, lora_alpha=16.0)
    step_u = make_vlm2vec_train_step(lmodel, sharded_base,
                                     grad_cache_chunks=2)
    s2 = TrainState.create(
        jax.device_put(lora_nz, NamedSharding(mesh, P())),
        adamw(0.0, weight_decay=0.0),
    )
    with mesh:
        s2, m_u = jax.jit(step_u)(s2, batch_sharded)
    loss_u, ref_nz = float(m_u["loss"]), float(m_ref_nz["loss"])
    np.testing.assert_allclose(loss_u, ref_nz, rtol=2e-4)


def test_clip_t5_tp(mesh):
    """TP-sharded CLIP-FlanT5 (the reference's DEFAULT VQAScore backbone,
    t2v_metrics/vqascore.py:11): T5 q/k/v + wi_0/wi_1 columns and o/wo rows
    shard over 'model' (parallel/sharding_rules.py). The sharded
    teacher-forced decoder logits must equal the replicated ones."""
    import jax.numpy as jnp

    from clip_embeds.core.config import VisionConfig
    from clip_embeds.models.clip_t5 import CLIPT5, CLIPT5Config
    from clip_embeds.models.t5 import T5Config
    from clip_embeds.parallel.sharding_rules import shard_params

    n_model = mesh.devices.shape[1]
    cfg = CLIPT5Config(
        t5=T5Config(vocab_size=256, d_model=64, d_kv=16,
                    d_ff=64 * max(n_model, 2), num_layers=2,
                    num_heads=2 * max(n_model, 2)),
        vision=VisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                            head_width=32),
    )
    model = CLIPT5(cfg, attn_impl="reference")
    rng = np.random.default_rng(4)
    ids = jnp.asarray([[1, 7, -200, 9, 11, 13]], jnp.int32)
    pixels = jnp.asarray(rng.standard_normal((1, 32, 32, 3)), jnp.float32)
    labels = jnp.asarray([[5, 6, 1, -100]], jnp.int32)
    params = model.init(jax.random.PRNGKey(0), ids, pixels, labels)["params"]
    want = np.asarray(
        model.apply({"params": params}, ids, pixels, labels), np.float32)
    sharded = shard_params(mesh, params)
    with mesh:
        got = np.asarray(jax.jit(
            lambda p, i, px, lb: model.apply({"params": p}, i, px, lb)
        )(sharded, ids, pixels, labels), np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    kern = sharded["t5"]["encoder"]["block_0"]["self_attn"]["q"]["kernel"]
    assert not kern.sharding.is_fully_replicated, "T5 TP leaf regathered"


def test_chip_smoke_multi_phase_on_four_cpu_devices():
    """``chip_smoke.py --multi``'s phase at tiny width on 4 CPU devices: one
    ``make_clip_train_step`` step on the dp=4 mesh against one device, a few
    steps of ``cli.train`` compiled once, and the SigLIP ring."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    code = ("import json, chip_smoke as cs\n"
            "rec = cs.phase_multi({}, 'cpu', model_name='test-tiny', "
            "per_device=4, train_steps=3)\n"
            "print(json.dumps(rec))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    step = rec["train_step"]
    assert step["replica_max_abs_diff"] == 0.0
    assert step["grad_cosine"] >= 0.999 and step["loss_rel_diff"] <= 5e-3
    assert "all-gather" in step["collectives"]
    assert rec["cli_train"]["devices"] == 4
    assert rec["cli_train"]["train_step_compiles"] == 1
