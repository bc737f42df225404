"""What running on another machine needs: the package imports without the
third-party packages a GPU host may lack, the compile cache goes where the
environment says, and chip_smoke.py refuses to run without a GPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, env_extra=None, env_drop=(), cwd=REPO, timeout=300):
    env = {k: v for k, v in os.environ.items() if k not in env_drop}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


_BLOCK = """
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked " + name)
sys.meta_path.insert(0, _Block())
"""


def test_package_imports_without_regex_and_pil():
    code = ("BLOCKED = {'regex', 'PIL'}\n" + _BLOCK
            + "import clip_embeds\n"
            + "assert 'regex' not in sys.modules and 'PIL' not in sys.modules\n"
            + "print(clip_embeds.get_tokenizer()('a photo of a cat')[0, :3])")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "49406" in proc.stdout


def test_package_builds_a_model_on_the_vendored_flax():
    code = ("BLOCKED = {'flax', 'orbax', 'etils', 'tensorstore', 'treescope'}\n"
            + _BLOCK
            + "import clip_embeds\n"
            + "model, params = clip_embeds.create_model('test-tiny')\n"
            + "assert type(model).__mro__[1].__module__.startswith("
            + "'clip_embeds._vendor.flax'), type(model).__mro__\n"
            + "assert 'flax' not in sys.modules\n"
            + "print(type(model).__name__)")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "CLIP" in proc.stdout


def test_compile_cache_goes_to_the_environment_directory(tmp_path):
    code = """
import jax, jax.numpy as jnp
from clip_embeds.core.compile_cache import enable_persistent_cache
path = enable_persistent_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(7)).block_until_ready()
print(path)
"""
    proc = _run(code, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split()[-1] == str(tmp_path)
    assert os.listdir(tmp_path), "no compiled entry written"


def test_compile_cache_defaults_to_the_checkout():
    code = """
import jax
from clip_embeds.core.compile_cache import enable_persistent_cache
print(enable_persistent_cache(), jax.config.jax_compilation_cache_dir)
"""
    proc = _run(code, env_drop=("JAX_COMPILATION_CACHE_DIR",))
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = os.path.join(REPO, ".jax_cache")
    assert proc.stdout.split() == [want, want]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    import shutil

    cwd = REPO
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_png_round_trips_through_native():
    from PIL import Image

    import chip_smoke
    from clip_embeds.image.loader import native_decode_preprocess
    from clip_embeds.image.preprocess import preprocess_clip

    rng = np.random.default_rng(0)
    arrs = [chip_smoke.synthetic_image(rng, h, w)
            for h, w in [(40, 57), (64, 64), (91, 33)]]
    res = native_decode_preprocess([chip_smoke.png_bytes(a) for a in arrs], 32)
    if res is None:
        pytest.skip("native library unavailable (no g++?)")
    out, ok = res
    assert ok.all()
    for got, arr in zip(out, arrs):
        np.testing.assert_allclose(
            got, preprocess_clip(Image.fromarray(arr), 32), rtol=0, atol=1e-5)
