"""get_score_model live construction + conversation-format parity tests.

The conversation formats (plain/chat/phi3_instruct/llama3) are checked
against the reference implementation loaded from /root/reference at runtime
(oracle pattern — never copied): conversation.py conv_templates +
llava_model.py:17-58 format_question/format_answer logic.
"""

import importlib.util
import sys

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp

from clip_embeds.core.config import VisionConfig
from clip_embeds.scores.build import (
    config_from_dict,
    config_to_dict,
    save_score_bundle,
)
from clip_embeds.scores.registry import get_score_model
from clip_embeds.scores.vqa_score import format_answer, format_question

REF_VQA = "/root/reference/t2v_metrics/t2v_metrics/models/vqascore_models"


def _load_ref_conversation():
    spec = importlib.util.spec_from_file_location(
        "_ref_conversation", f"{REF_VQA}/conversation.py"
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules["_ref_conversation"] = mod
    spec.loader.exec_module(mod)
    return mod


def _ref_format_question(question, style, conv_templates):
    """Reference llava_model.py:17-42 logic run against the oracle
    Conversation templates."""
    SYSTEM_MSG = (
        "A chat between a curious user and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite "
        "answers to the user's questions."
    )
    if style == "plain":
        return "<image>" + question
    if style == "chat":
        return (SYSTEM_MSG + " USER: " + "<image>" + "\n" + question
                + " ASSISTANT: ")
    qs = "<image>" + "\n" + question
    conv = conv_templates[style].copy()
    conv.append_message(conv.roles[0], qs)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


@pytest.mark.parametrize("style", ["plain", "chat", "phi3_instruct", "llama3"])
def test_conversation_format_parity(style):
    ref = _load_ref_conversation()
    q = 'Does this figure show "a cat on a mat"? Please answer yes or no.'
    assert format_question(q, style) == _ref_format_question(
        q, style, ref.conv_templates
    )
    ends = {"plain": "\n", "chat": "</s>", "phi3_instruct": "<|end|>",
            "llama3": "<|eot_id|>"}
    assert format_answer("Yes", style) == "Yes" + ends[style]


def test_config_roundtrip():
    from clip_embeds.models.instructblip import InstructBlipConfig
    from clip_embeds.models.llava import LlavaConfig

    for cfg in (LlavaConfig(), InstructBlipConfig()):
        d = config_to_dict(cfg)
        import json

        d = json.loads(json.dumps(d))  # simulate the file round trip
        assert config_from_dict(type(cfg), d) == cfg


def test_default_model_configs_cover_registry():
    from clip_embeds.scores.build import default_model_config
    from clip_embeds.scores.registry import (
        BLIP2_ITC_MODELS,
        BLIP2_ITM_MODELS,
        IMAGE_REWARD_MODELS,
        CLIP_T5_MODELS,
        INSTRUCTBLIP_MODELS,
        LLAVA_LLAMA_MODELS,
        LLAVA_MODELS,
    )

    for name in (LLAVA_MODELS + LLAVA_LLAMA_MODELS + CLIP_T5_MODELS
                 + INSTRUCTBLIP_MODELS + BLIP2_ITM_MODELS + BLIP2_ITC_MODELS
                 + IMAGE_REWARD_MODELS):
        cfg = default_model_config(name)
        assert cfg is not None
    # spot-check paper-added backbone shapes
    phi = default_model_config("llava-phi-3")
    assert phi.llama.hidden_size == 3072 and phi.llama.vocab_size == 32064
    l3 = default_model_config("llava-llama-3")
    assert l3.llama.num_kv_heads == 8 and l3.llama.rope_theta == 500000.0


def _toy_tokenize(text):
    return [(hash(w) % 200) + 5 for w in text.replace("\n", " ").split()]


def _img():
    rng = np.random.default_rng(0)
    return Image.fromarray(rng.integers(0, 255, (40, 40, 3), np.uint8))


@pytest.mark.parametrize("name,style", [
    ("llava-v1.5-7b", "chat"), ("llava-phi-3", "phi3_instruct"),
    ("llava-llama-3", "llama3"), ("llava-v1.6-13b", "chat"),
])
@pytest.mark.slow
def test_get_score_model_llava_family(tmp_path, name, style):
    from clip_embeds.models.llama import LlamaConfig
    from clip_embeds.models.llava import (
        IMAGE_TOKEN_INDEX,
        Llava,
        LlavaConfig,
    )

    cfg = LlavaConfig(
        llama=LlamaConfig(vocab_size=256, hidden_size=64,
                          intermediate_size=128, num_layers=2, num_heads=4,
                          max_position_embeddings=128),
        vision=VisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                            head_width=32),
    )
    model = Llava(cfg)
    ids = np.full((1, 8), 7, np.int32)
    ids[0, 2] = IMAGE_TOKEN_INDEX
    params = model.init(
        jax.random.PRNGKey(0), jnp.asarray(ids),
        jnp.zeros((1, 32, 32, 3), jnp.float32),
    )["params"]
    bundle = tmp_path / f"{name}-bundle"
    save_score_bundle(str(bundle), "llava", cfg, params, conversation=style)

    score = get_score_model(name, checkpoint=str(bundle),
                            tokenize=_toy_tokenize, batch_size=2)
    out = score([_img()], ["a cat", "a dog"])
    assert out.shape == (1, 2)
    assert np.isfinite(out).all() and (out > 0).all() and (out <= 1).all()


@pytest.mark.slow
def test_get_score_model_clip_t5(tmp_path):
    from clip_embeds.models.clip_t5 import CLIPT5, CLIPT5Config
    from clip_embeds.models.llava import IMAGE_TOKEN_INDEX
    from clip_embeds.models.t5 import T5Config

    cfg = CLIPT5Config(
        t5=T5Config(vocab_size=256, d_model=64, d_kv=16, d_ff=128,
                    num_layers=2, num_heads=4),
        vision=VisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                            head_width=32),
    )
    model = CLIPT5(cfg)
    ids = np.full((1, 8), 7, np.int32)
    ids[0, 2] = IMAGE_TOKEN_INDEX
    params = model.init(
        jax.random.PRNGKey(0), jnp.asarray(ids),
        jnp.zeros((1, 32, 32, 3), jnp.float32),
        jnp.zeros((1, 4), jnp.int32),
    )["params"]
    bundle = tmp_path / "t5-bundle"
    save_score_bundle(str(bundle), "clip_t5", cfg, params,
                      conversation="t5_chat")

    score = get_score_model("clip-flant5-xxl", checkpoint=str(bundle),
                            tokenize=_toy_tokenize, batch_size=2)
    out = score([_img()], ["a cat", "a dog"])
    assert out.shape == (1, 2)
    assert np.isfinite(out).all() and (out > 0).all()


@pytest.mark.slow
def test_get_score_model_instructblip(tmp_path):
    from clip_embeds.models.blip2 import QFormerConfig
    from clip_embeds.models.instructblip import (
        InstructBlipConfig,
        InstructBlipT5,
    )
    from clip_embeds.models.t5 import T5Config

    cfg = InstructBlipConfig(
        vision=VisionConfig(image_size=32, patch_size=16, width=64,
                            layers=2, head_width=32),
        qformer=QFormerConfig(vocab_size=256, hidden_size=48, num_layers=2,
                              num_heads=4, intermediate_size=96,
                              encoder_hidden_size=64),
        t5=T5Config(vocab_size=256, d_model=48, d_kv=12, d_ff=96,
                    num_layers=2, num_heads=4),
        num_query_tokens=4,
    )
    model = InstructBlipT5(cfg)
    params = model.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, 32, 32, 3), jnp.float32),
        jnp.zeros((1, 4), jnp.int32),
        jnp.zeros((1, 6), jnp.int32),
        jnp.zeros((1, 3), jnp.int32),
    )["params"]
    bundle = tmp_path / "ib-bundle"
    save_score_bundle(str(bundle), "instructblip", cfg, params)

    score = get_score_model(
        "instructblip-flant5-xl", checkpoint=str(bundle),
        tokenize=_toy_tokenize, qformer_tokenize=_toy_tokenize, batch_size=2,
    )
    out = score([_img()], ["a cat", "a dog"])
    assert out.shape == (1, 2)
    assert np.isfinite(out).all() and (out > 0).all()


def _tiny_blip2_cfg():
    from clip_embeds.models.blip2 import Blip2Config, QFormerConfig

    return Blip2Config(
        vision=VisionConfig(image_size=32, patch_size=16, width=64,
                            layers=2, head_width=32),
        qformer=QFormerConfig(vocab_size=256, hidden_size=48, num_layers=2,
                              num_heads=4, intermediate_size=96,
                              encoder_hidden_size=64),
        num_query_tokens=4,
        image_text_hidden_size=16,
    )


@pytest.mark.slow
def test_get_score_model_blip2_itm(tmp_path):
    from clip_embeds.models.blip2 import Blip2ITM

    cfg = _tiny_blip2_cfg()
    model = Blip2ITM(cfg)
    params = model.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, 32, 32, 3), jnp.float32),
        jnp.zeros((1, 5), jnp.int32),
        method="itm_logits",
    )["params"]
    bundle = tmp_path / "itm-bundle"
    save_score_bundle(str(bundle), "blip2_itm", cfg, params)

    score = get_score_model("blip2-itm", checkpoint=str(bundle),
                            tokenize=_toy_tokenize, batch_size=2)
    out = score([_img()], ["a cat", "a dog"])
    assert out.shape == (1, 2)
    assert ((out >= 0) & (out <= 1)).all()  # softmax[:, 1]


@pytest.mark.slow
def test_get_score_model_blip2_itc(tmp_path):
    from clip_embeds.models.blip2 import Blip2ITM

    cfg = _tiny_blip2_cfg()
    model = Blip2ITM(cfg)
    params = model.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, 32, 32, 3), jnp.float32),
        jnp.zeros((1, 5), jnp.int32),
        method="itc_embeds",
    )["params"]
    bundle = tmp_path / "itc-bundle"
    save_score_bundle(str(bundle), "blip2_itc", cfg, params)

    score = get_score_model("blip2-itc", checkpoint=str(bundle),
                            tokenize=_toy_tokenize, batch_size=2)
    out = score([_img()], ["a cat", "a dog"])
    assert out.shape == (1, 2)
    assert ((out >= -1) & (out <= 1)).all()  # cosine


@pytest.mark.slow
def test_get_score_model_image_reward(tmp_path):
    from clip_embeds.models.blip import (
        BlipConfig,
        BlipTextConfig,
        ImageReward,
    )

    cfg = BlipConfig(
        vision=VisionConfig(image_size=32, patch_size=16, width=48,
                            layers=2, head_width=24),
        text=BlipTextConfig(vocab_size=256, hidden_size=48, num_layers=2,
                            num_heads=4, intermediate_size=96),
    )
    model = ImageReward(cfg)
    params = model.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, 32, 32, 3), jnp.float32),
        jnp.zeros((1, 5), jnp.int32),
        jnp.ones((1, 5), bool),
    )["params"]
    bundle = tmp_path / "ir-bundle"
    save_score_bundle(str(bundle), "image_reward", cfg, params)

    score = get_score_model("image-reward-v1", checkpoint=str(bundle),
                            tokenize=_toy_tokenize, batch_size=2)
    out = score([_img()], ["a cat", "a dog"])
    assert out.shape == (1, 2)
    assert np.isfinite(out).all()


def test_get_score_model_gpt4v():
    def complete(question, image):
        return [("Yes", np.log(0.75)), ("No", np.log(0.2))]

    score = get_score_model("gpt-4o", complete=complete)
    out = score(["/tmp/fake.jpg"], ["a cat"])
    assert out.shape == (1, 1)
    np.testing.assert_allclose(out[0, 0], 0.75, rtol=1e-6)


@pytest.mark.slow
def test_convert_cli_llava_end_to_end(tmp_path):
    """cli/convert: HF LLaVA checkpoint -> score bundle -> live scorer,
    one command (the real-weights onboarding path)."""
    torch = pytest.importorskip("torch")
    from transformers import CLIPVisionConfig, LlamaConfig as HFLlamaConfig
    from transformers import LlavaConfig as HFLlavaConfig
    from transformers import LlavaForConditionalGeneration

    vision_cfg = CLIPVisionConfig(
        hidden_size=64, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=2, image_size=32, patch_size=16,
        hidden_act="quick_gelu",
    )
    text_cfg = HFLlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        max_position_embeddings=128, attn_implementation="eager",
    )
    hf_cfg = HFLlavaConfig(
        vision_config=vision_cfg, text_config=text_cfg,
        image_token_index=99, vision_feature_layer=-2,
        vision_feature_select_strategy="default",
        projector_hidden_act="gelu",
    )
    torch.manual_seed(0)
    hf = LlavaForConditionalGeneration(hf_cfg).eval()
    ckpt = tmp_path / "hf.pt"
    torch.save(hf.state_dict(), str(ckpt))

    from clip_embeds.models.llama import LlamaConfig
    from clip_embeds.models.llava import LlavaConfig
    from clip_embeds.scores.build import config_to_dict

    tiny = LlavaConfig(
        llama=LlamaConfig(vocab_size=256, hidden_size=64,
                          intermediate_size=128, num_layers=2, num_heads=4,
                          max_position_embeddings=128),
        vision=VisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                            head_width=32),
    )
    cfg_json = tmp_path / "tiny.json"
    import json

    cfg_json.write_text(json.dumps(config_to_dict(tiny)))

    from clip_embeds.cli.convert import main as convert_main

    out = tmp_path / "bundle"
    rc = convert_main([
        "--name", "llava-v1.5-7b", "--checkpoint", str(ckpt),
        "--out", str(out), "--config", str(cfg_json),
    ])
    assert rc == 0

    score = get_score_model("llava-v1.5-7b", checkpoint=str(out),
                            tokenize=_toy_tokenize, batch_size=2)
    result = score([_img()], ["a cat", "a dog"])
    assert result.shape == (1, 2)
    assert np.isfinite(result).all() and (result > 0).all()


@pytest.mark.slow
def test_convert_cli_llava_phi3_route(tmp_path):
    """cli/convert llava-phi-3: HF LLaVA layout with a Phi-3 LM
    (packed qkv_proj/gate_up_proj split by convert_phi3_state_dict)."""
    torch = pytest.importorskip("torch")
    from transformers import CLIPVisionConfig, LlavaConfig as HFLlavaConfig
    from transformers import LlavaForConditionalGeneration, Phi3Config

    vision_cfg = CLIPVisionConfig(
        hidden_size=64, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=2, image_size=32, patch_size=16,
        hidden_act="quick_gelu",
    )
    phi_cfg = Phi3Config(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        max_position_embeddings=128, attn_implementation="eager",
        pad_token_id=0,  # Phi-3 default 32000 exceeds the tiny vocab
    )
    hf_cfg = HFLlavaConfig(
        vision_config=vision_cfg, text_config=phi_cfg,
        image_token_index=99, vision_feature_layer=-2,
        vision_feature_select_strategy="default",
        projector_hidden_act="gelu",
    )
    torch.manual_seed(0)
    hf = LlavaForConditionalGeneration(hf_cfg).eval()
    ckpt = tmp_path / "hf_phi3.pt"
    torch.save(hf.state_dict(), str(ckpt))

    from clip_embeds.models.llama import LlamaConfig
    from clip_embeds.models.llava import LlavaConfig
    from clip_embeds.scores.build import config_to_dict

    tiny = LlavaConfig(
        llama=LlamaConfig(vocab_size=256, hidden_size=64,
                          intermediate_size=128, num_layers=2, num_heads=4,
                          num_kv_heads=4, max_position_embeddings=128),
        vision=VisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                            head_width=32),
    )
    import json

    cfg_json = tmp_path / "tiny.json"
    cfg_json.write_text(json.dumps(config_to_dict(tiny)))

    from clip_embeds.cli.convert import main as convert_main

    out = tmp_path / "bundle"
    rc = convert_main([
        "--name", "llava-phi-3", "--checkpoint", str(ckpt),
        "--out", str(out), "--config", str(cfg_json),
    ])
    assert rc == 0

    score = get_score_model("llava-phi-3", checkpoint=str(out),
                            tokenize=_toy_tokenize, batch_size=2)
    result = score([_img()], ["a cat"])
    assert result.shape == (1, 1) and np.isfinite(result).all()


@pytest.mark.slow
def test_get_score_model_llava_int8_trunk(tmp_path):
    """quant=True routes the LLaVA trunk through W8A8 QuantDense
    (build.py llava branch; models/quant.py quantize_llava_trunk) — scores
    stay close to the fp path."""
    from clip_embeds.models.llama import LlamaConfig
    from clip_embeds.models.llava import (
        IMAGE_TOKEN_INDEX,
        Llava,
        LlavaConfig,
    )

    cfg = LlavaConfig(
        llama=LlamaConfig(vocab_size=256, hidden_size=64,
                          intermediate_size=128, num_layers=2, num_heads=4,
                          max_position_embeddings=128),
        vision=VisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                            head_width=32),
    )
    model = Llava(cfg)
    ids = np.full((1, 8), 7, np.int32)
    ids[0, 2] = IMAGE_TOKEN_INDEX
    params = model.init(
        jax.random.PRNGKey(0), jnp.asarray(ids),
        jnp.zeros((1, 32, 32, 3), jnp.float32),
    )["params"]
    bundle = tmp_path / "llava-bundle"
    save_score_bundle(str(bundle), "llava", cfg, params, conversation="chat")

    fp = get_score_model("llava-v1.5-7b", checkpoint=str(bundle),
                         tokenize=_toy_tokenize, batch_size=2)
    q = get_score_model("llava-v1.5-7b", checkpoint=str(bundle),
                        tokenize=_toy_tokenize, batch_size=2, quant=True)
    imgs, texts = [_img()], ["a cat", "a dog"]
    out_fp = fp(imgs, texts)
    out_q = q(imgs, texts)
    assert out_q.shape == (1, 2)
    assert np.all(np.abs(out_q - out_fp) < 0.15), (out_q, out_fp)


@pytest.mark.slow
def test_get_score_model_llava_scan_trunk(tmp_path):
    """scan=True restacks the bundle's unrolled params and serves through
    the lax.scan trunk — scores equal the unrolled path (compile-time
    deployment option)."""
    from clip_embeds.models.llama import LlamaConfig
    from clip_embeds.models.llava import (
        IMAGE_TOKEN_INDEX,
        Llava,
        LlavaConfig,
    )

    cfg = LlavaConfig(
        llama=LlamaConfig(vocab_size=256, hidden_size=64,
                          intermediate_size=128, num_layers=2, num_heads=4,
                          max_position_embeddings=128),
        vision=VisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                            head_width=32),
    )
    model = Llava(cfg)
    ids = np.full((1, 8), 7, np.int32)
    ids[0, 2] = IMAGE_TOKEN_INDEX
    params = model.init(
        jax.random.PRNGKey(0), jnp.asarray(ids),
        jnp.zeros((1, 32, 32, 3), jnp.float32),
    )["params"]
    bundle = tmp_path / "llava-bundle"
    save_score_bundle(str(bundle), "llava", cfg, params, conversation="chat")

    plain = get_score_model("llava-v1.5-7b", checkpoint=str(bundle),
                            tokenize=_toy_tokenize, batch_size=2)
    scan = get_score_model("llava-v1.5-7b", checkpoint=str(bundle),
                           tokenize=_toy_tokenize, batch_size=2, scan=True)
    imgs, texts = [_img()], ["a cat", "a dog"]
    np.testing.assert_allclose(scan(imgs, texts), plain(imgs, texts),
                               rtol=2e-5, atol=2e-5)
