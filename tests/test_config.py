"""Config parsing without PyYAML, the compile-cache rule, and chip_smoke.py's
refusal to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from eincm_tpu.experiments.config import (
    ExperimentConfig,
    _parse_value,
    apply_overrides,
    load_config,
)

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize(
    "raw,expected",
    [
        ("3", 3),
        ("-2.5", -2.5),
        ("1e-5", 1e-5),  # bare exponent: YAML 1.1 would keep a string
        ("1.0e-5", 1e-5),
        ("true", True),
        ("False", False),
        ("null", None),
        ("~", None),
        ("[480, 640]", [480, 640]),
        ("{0: 2, 1: 2}", {0: 2, 1: 2}),
        ("[true, false]", [True, False]),
        ("synthetic", "synthetic"),
        ("'quoted'", "quoted"),
        ("outputs/run_1", "outputs/run_1"),
        ("~/data", "~/data"),
        ("trueish", "trueish"),
    ],
)
def test_parse_value_without_yaml(raw, expected):
    got = _parse_value(raw)
    assert got == expected and type(got) is type(expected)


@pytest.mark.parametrize(
    "key", ["splat_impl", "interp_impl", "splat_multiref_stacked"]
)
def test_removed_solver_keys_are_named_in_the_error(key):
    with pytest.raises(KeyError, match=key):
        apply_overrides(ExperimentConfig(), [f"solver.{key}=xla"])
    with pytest.raises(KeyError, match=key):
        ExperimentConfig.from_dict({"solver": {key: "xla"}})


def test_overrides_and_defaults_need_no_yaml(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml -> error
    cfg = load_config(None, ["dataset.sensor_size=[480, 640]",
                             "solver.n_extra_attempts={0: 2, 4: 2}",
                             "handover.solve_handover_for_levels=[0]",
                             "solver.theta_ftol=1e-5"])
    assert tuple(cfg.dataset.sensor_size) == (480, 640)
    assert cfg.solver.n_extra_attempts == {0: 2, 4: 2}
    assert cfg.solver.theta_ftol == 1e-5
    assert cfg.solver_config().n_extra_attempts == {0: 2, 4: 2}


def test_yaml_file_without_yaml_names_the_module(monkeypatch, tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("alpha: 33\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="yaml"):
        load_config(str(p))


@pytest.mark.parametrize(
    "env,explicit,expected",
    [
        ("/cache/from/env", None, "/cache/from/env"),
        ("/cache/from/env", "/cache/explicit", "/cache/from/env"),
        (None, "/cache/explicit", "/cache/explicit"),
        (None, None, str(REPO / ".jax_cache")),
    ],
)
def test_compilation_cache_rule(monkeypatch, env, explicit, expected):
    import jax

    from eincm_tpu.utils import jax_helpers

    set_paths = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: set_paths.append((k, v)))
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    assert jax_helpers.enable_compilation_cache(explicit) == expected
    if env is None:
        assert set_paths == [("jax_compilation_cache_dir", expected)]
    else:
        assert set_paths == []  # JAX reads its own variable


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _prints_result(stdout):
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return "ok" in json.loads(lines[-1])
    except json.JSONDecodeError:
        return False


def test_chip_smoke_refuses_without_gpu():
    res = _run_smoke(REPO, REPO / "chip_smoke.py")
    assert res.returncode != 0
    assert "no GPU" in res.stderr
    assert not _prints_result(res.stdout)


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path, tmp_path / "chip_smoke.py")
    assert res.returncode != 0
    assert "no eincm_tpu" in res.stderr
    assert not _prints_result(res.stdout)
