"""The port's asset loader and its independence from JAX.

The loader runs in a subprocess in which importing jax, jaxlib, ml_dtypes
or the JAX package raises, as on a machine that has none of them. This is
the only test file that reads bench_assets/flagship.ckpt (160 MB)."""

import ast
import hashlib
import io
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from nerfsafetyvalidation_tpu_torch import assets
from nerfsafetyvalidation_tpu_torch.ops.hopper import points_mlp

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "nerfsafetyvalidation_tpu_torch"
CKPT = ROOT / "bench_assets" / "flagship.ckpt"
STUDENT = ROOT / "bench_assets" / "bench_student_h160x6.pkl"
FORBIDDEN = {"jax", "jaxlib", "ml_dtypes", "optax", "nerfsafetyvalidation_tpu",
             "cv2"}
# imports the port may make only optionally (inside a try whose handler
# takes ImportError, with a fallback): the estimator's SIFT interest points
# and the Blender camera's half-size resize read cv2 where it is installed,
# as the JAX package's estimator does
OPTIONAL = {"cv2"}

_CHILD = r"""
import hashlib, json, sys

class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {"jax", "jaxlib", "ml_dtypes",
                                  "nerfsafetyvalidation_tpu"}:
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, _Blocked())
from nerfsafetyvalidation_tpu_torch.assets import (
    load_renderer_state, load_student, params_from_jax)

state = load_renderer_state(sys.argv[1], device="cpu")
bf = state.density_bitfield.numpy()
params = params_from_jax(load_student(sys.argv[2]), device="cpu")
print(json.dumps({
    "bitfield_dtype": str(bf.dtype), "bitfield_shape": list(bf.shape),
    "bitfield_sha256": hashlib.sha256(bf.tobytes()).hexdigest(),
    "shapes": {k: [list(w.shape) for w in v] for k, v in params.items()},
    "dtypes": sorted({str(w.dtype) for v in params.values() for w in v}),
    "imported": sorted(m for m in sys.modules
                       if m.split(".")[0] in {"jax", "ml_dtypes",
                                              "nerfsafetyvalidation_tpu"}),
}))
"""


def test_loader_runs_without_jax_and_matches_plain_pickle():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(CKPT),
                           str(STUDENT)], capture_output=True, text=True,
                          cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["imported"] == []
    assert got["bitfield_dtype"] == "uint8"
    assert got["bitfield_shape"] == [128 ** 3 // 8]
    # the same checkpoint through plain pickle, with ml_dtypes and the JAX
    # package importable here
    with open(CKPT, "rb") as f:
        ref = np.asarray(pickle.load(f)["renderer_state"].density_bitfield)
    assert got["bitfield_sha256"] == hashlib.sha256(
        ref.astype(np.uint8).tobytes()).hexdigest()
    with open(STUDENT, "rb") as f:
        ref_p = pickle.load(f)["params"]
    assert got["shapes"] == {k: [list(np.shape(w)) for w in v]
                             for k, v in ref_p.items()}
    assert got["dtypes"] == ["torch.float32"]


_CHILD_TEACHER = _CHILD.split("from nerfsafetyvalidation_tpu_torch")[0] + r"""
import numpy as np
from nerfsafetyvalidation_tpu_torch.assets import load_checkpoint

params, state = load_checkpoint(sys.argv[1], device="cpu")
leaves = {"sigma_net": params["sigma_net"], "color_net": params["color_net"],
          "pyramid": params["encoder"]["pyramid"],
          "hash": [params["encoder"]["hash"]]}
rs = {k: getattr(state, k) for k in ("density_grid", "density_bitfield",
                                     "mean_density", "iter_density",
                                     "skip_grid")}
def digest(t):
    a = t.numpy()
    return [str(a.dtype), list(a.shape), hashlib.sha256(a.tobytes()).hexdigest()]
print(json.dumps({
    "params": {k: [digest(w) for w in v] for k, v in leaves.items()},
    "state": {k: digest(v) for k, v in rs.items()},
    "imported": sorted(m for m in sys.modules
                       if m.split(".")[0] in {"jax", "ml_dtypes",
                                              "nerfsafetyvalidation_tpu"}),
}))
"""


def test_teacher_loader_decodes_bf16_bit_exact_without_jax():
    """load_checkpoint with jax, jaxlib, ml_dtypes and the JAX package
    blocked; every array equals bench.py's upcast (ml_dtypes bfloat16 ->
    float32 through plain pickle), bit for bit."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _CHILD_TEACHER, str(CKPT)],
                          capture_output=True, text=True, cwd=ROOT, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["imported"] == []

    def digest(a):
        a = np.array(a, order="C")
        return [str(a.dtype), list(a.shape),
                hashlib.sha256(a.tobytes()).hexdigest()]

    def up(a):      # bench.py _upcast_asset
        a = np.asarray(a)
        return a.astype(np.float32) if a.dtype.name == "bfloat16" else a

    with open(CKPT, "rb") as f:
        ref = pickle.load(f)
    m = ref["model"]
    want = {"sigma_net": m["sigma_net"], "color_net": m["color_net"],
            "pyramid": m["encoder"]["pyramid"], "hash": [m["encoder"]["hash"]]}
    assert got["params"] == {k: [digest(up(w)) for w in v]
                             for k, v in want.items()}
    rs = ref["renderer_state"]
    assert got["state"] == {k: digest(up(getattr(rs, k))) for k in
                            ("density_grid", "density_bitfield",
                             "mean_density", "iter_density", "skip_grid")}
    assert got["state"]["density_grid"][:2] == ["float32", [1, 128 ** 3]]
    assert got["params"]["hash"][0][:2] == ["float32", [2 ** 19, 128]]


def test_student_weights_are_bit_exact():
    got = assets.params_from_jax(assets.load_student(STUDENT), device="cpu")
    with open(STUDENT, "rb") as f:
        ref = pickle.load(f)["params"]
    for k in ("sigma_net", "color_net"):
        assert len(got[k]) == len(ref[k])
        for g, r in zip(got[k], ref[k]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_unpickler_refuses_other_classes():
    blob = pickle.dumps({"x": io.BytesIO(b"")})
    with pytest.raises(pickle.UnpicklingError):
        assets._Unpickler(io.BytesIO(blob)).load()


def _guarded(tree):
    """The import nodes that sit in the body of a try whose handlers take
    ImportError (or Exception, or everything)."""
    out = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        names = {getattr(h.type, "id", None) for h in node.handlers}
        if names & {None, "ImportError", "Exception"}:
            out.update(id(n) for stmt in node.body for n in ast.walk(stmt)
                       if isinstance(n, (ast.Import, ast.ImportFrom)))
    return out


def _imports(path):
    """(module, optional) of every absolute import in the file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    guarded = _guarded(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((a.name, id(node) in guarded) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, id(node) in guarded


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    """No JAX, optax or JAX-package import anywhere in the port, and cv2
    only as an optional import with a fallback."""
    bad = [m for m, optional in _imports(path)
           if m.split(".")[0] in FORBIDDEN
           and not (optional and m.split(".")[0] in OPTIONAL)]
    assert bad == [], f"{path.name} imports {bad}"


def test_kernel_build_route():
    """K1 is CUDA C++ built by nvcc for sm_90a and bound with ctypes:
    no PyTorch extension build, no fast-math sine."""
    flags = " ".join(points_mlp.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    src = points_mlp.SOURCE.read_text()
    assert "__sinf" not in src and "__cosf" not in src
    assert 'extern "C"' in src and "torch/extension.h" not in src
    for path in PORT.rglob("*.py"):
        assert "cpp_extension" not in path.read_text(), path
