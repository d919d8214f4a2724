"""The port's own copies of host-side code (config schema, misc helpers)
held equal to the JAX package's, and the port's isolation: importing any
port module, or chip_smoke.py, pulls in neither JAX nor diffusioniqt_tpu."""

import dataclasses
import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffusioniqt_tpu import config as jcfg
from diffusioniqt_tpu.utils import misc as jmisc
from diffusioniqt_tpu_torch import config as tcfg
from diffusioniqt_tpu_torch.utils import misc as tmisc

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "config", "*.yaml")))


def test_four_configs_present():
    assert len(CONFIGS) == 4


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_field_equal(path):
    a, b = jcfg.load_config(path), tcfg.load_config(path)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.data.min_bound == b.data.min_bound
    assert a.train.patch_size == b.train.patch_size
    assert a.to_dict() == b.to_dict()


def test_use_se_trailing_comma_quirk(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("Train:\n  use_se: True,\n  att_enc: ['False,', True]\n")
    for mod in (jcfg, tcfg):
        cfg = mod.load_config(str(p))
        assert cfg.train.use_se is True
        assert cfg.train.att_enc == (False, True)


def test_misc_helpers_equal():
    x = np.random.default_rng(0).standard_normal(257).astype(np.float32) * 6
    np.testing.assert_allclose(tmisc.mish(torch.from_numpy(x)).numpy(),
                               np.asarray(jmisc.mish(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    for val, length in ((3, 2), ([1, 2], 2), ((4,), None), (5, None)):
        assert tmisc.cast_tuple(val, length) == jmisc.cast_tuple(val, length)
    with pytest.raises(ValueError):
        tmisc.cast_tuple((1, 2), 3)
    assert tmisc.default(None, lambda: 7) == jmisc.default(None, lambda: 7) == 7
    assert tmisc.exists(0) and not tmisc.exists(None)


def test_resolve_device_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmisc.resolve_device("cuda")
    assert tmisc.resolve_device("cpu") == torch.device("cpu")


_ISOLATION = r"""
import importlib, pkgutil, runpy, sys
sys.path.insert(0, {root!r})
import diffusioniqt_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
runpy.run_path({smoke!r}, run_name="chip_smoke_import_only")
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "jaxlib"
       or m == "diffusioniqt_tpu" or m.startswith("diffusioniqt_tpu.")]
print(len(names), bad)
"""


def test_port_imports_no_jax_in_fresh_process():
    code = _ISOLATION.format(root=ROOT, smoke=os.path.join(ROOT, "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 15
    assert bad == "[]"


def test_port_sources_name_no_jax():
    files = glob.glob(os.path.join(ROOT, "diffusioniqt_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(ROOT, "chip_smoke.py")]
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|diffusioniqt_tpu)(\.|\s|$)",
        re.M)
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert offenders == []
