"""The port stands alone: kfnet_tpu_torch and chip_smoke.py import nothing
of JAX, of the JAX package or of the root __graft_entry__ (nor orbax,
tensorstore, zstandard, cv2 or PIL: the card's machine has none of them)
and load nothing of its native/ library, the kernel build carries the flags it
must, and chip_smoke.py refuses to run, printing no verdict, where there
is no CUDA device or no port beside it. No nvcc or GPU is needed here.
"""

import ast
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

import pytest

from kfnet_tpu_torch.kernels import _build

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "kfnet_tpu", "__graft_entry__", "orbax",
             "optax", "tensorstore", "zstandard", "cv2", "PIL")
PORT_FILES = sorted((ROOT / "kfnet_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path):
  tree = ast.parse(path.read_text(), filename=str(path))
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for a in node.names:
        yield a.name.split(".")[0]
    elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
      yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_forbidden_imports(path):
  bad = set(_imported_roots(path)) & set(FORBIDDEN)
  assert not bad, f"{path} imports {bad}"


# the JAX package's native library: its directory as a path component, or
# the name of its committed binary
NATIVE_REFERENCE = re.compile(r"""native/|["']native["']|libkfnet_native""")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_reference_to_the_jax_packages_native_library(path):
  hits = [line for line in path.read_text().splitlines()
          if NATIVE_REFERENCE.search(line)]
  assert not hits, f"{path} refers to native/: {hits}"


def test_host_library_is_built_from_the_ports_own_source():
  from kfnet_tpu_torch.data import native_io
  assert all(pathlib.Path(s).resolve().is_relative_to(ROOT / "kfnet_tpu_torch")
             for s in native_io.SOURCES)
  loaded = pathlib.Path(native_io.load_library()._name).resolve()
  assert loaded.parent == pathlib.Path(_build.build_dir()).resolve()
  assert not loaded.is_relative_to(ROOT / "native")


def test_host_build_flags():
  cmd = _build.host_command("g++", ["a.cpp"], "out.so")
  for flag in ("-O3", "-std=c++17", "-fPIC", "-shared", "-lz"):
    assert flag in cmd
  assert not any("march" in c for c in cmd)
  assert cmd[cmd.index("-o") + 1] == "out.so"


def test_checkpoint_reader_is_its_own_library_on_libc_alone():
  """The zstd decoder builds as kfnet_ckpt from the port's source and
  links no library (no -lz, no -lzstd), apart from the data path's."""
  from kfnet_tpu_torch.data import native_io
  from kfnet_tpu_torch.utils import ocdbt
  assert ocdbt.LIBRARY != native_io.LIBRARY
  assert all(pathlib.Path(s).resolve().is_relative_to(ROOT / "kfnet_tpu_torch")
             for s in ocdbt.SOURCES)
  cmd = _build.host_command("g++", list(ocdbt.SOURCES), "out.so", libs=())
  assert not any(c.startswith("-l") for c in cmd)
  loaded = pathlib.Path(ocdbt.load_library()._name).resolve()
  assert loaded.name.startswith(f"lib{ocdbt.LIBRARY}-")
  assert loaded.parent == pathlib.Path(_build.build_dir()).resolve()


def _imported_modules(path):
  tree = ast.parse(path.read_text(), filename=str(path))
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      yield from (a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
      yield node.module
      yield from (f"{node.module}.{a.name}" for a in node.names)


def test_kernels_and_core_import_no_models():
  # the layers, bottom up: core, kernels, models, then losses and train;
  # the heads' output steps the kernels need live in core (core/heads.py)
  pkg = ROOT / "kfnet_tpu_torch"
  for path in sorted((pkg / "kernels").glob("*.py")) + sorted(
      (pkg / "core").glob("*.py")):
    above = [m for m in _imported_modules(path)
             if m.startswith(("kfnet_tpu_torch.models",
                              "kfnet_tpu_torch.eval",
                              "kfnet_tpu_torch.train",
                              "kfnet_tpu_torch.losses"))]
    assert not above, f"{path.relative_to(ROOT)} imports {above}"


def test_package_import_leaves_jax_out():
  code = ("import sys, kfnet_tpu_torch.eval.online, kfnet_tpu_torch.convert;"
          "import kfnet_tpu_torch.kernels.fused_filter;"
          "import kfnet_tpu_torch.kernels.conv3x3;"
          "import kfnet_tpu_torch.tools.profile_online;"
          "import kfnet_tpu_torch.filter.sequence;"
          "import kfnet_tpu_torch.eval.eval_sequence;"
          "import kfnet_tpu_torch.eval.benchmark;"
          "import kfnet_tpu_torch.eval.flops;"
          "import kfnet_tpu_torch.pose.metrics;"
          "import kfnet_tpu_torch.utils.timing;"
          "import kfnet_tpu_torch.bench;"
          "import kfnet_tpu_torch.pretrained, kfnet_tpu_torch.configs;"
          "import kfnet_tpu_torch.data.synthetic, kfnet_tpu_torch.data.labels;"
          "import kfnet_tpu_torch.pose.p3p, kfnet_tpu_torch.pose.smoothing;"
          "import kfnet_tpu_torch.tools.batch_invariance;"
          "import kfnet_tpu_torch.tools.bench_configs;"
          "import kfnet_tpu_torch.losses.nll;"
          "import kfnet_tpu_torch.train.objectives;"
          "import kfnet_tpu_torch.train.trainer;"
          "import kfnet_tpu_torch.train.device_fit;"
          "import kfnet_tpu_torch.utils.logging;"
          "import kfnet_tpu_torch.utils.checkpoint;"
          "import kfnet_tpu_torch.tools.demo;"
          "import kfnet_tpu_torch.utils.config;"
          "import kfnet_tpu_torch.data.image_io, kfnet_tpu_torch.data.native_io;"
          "import kfnet_tpu_torch.data.seven_scenes;"
          "import kfnet_tpu_torch.data.twelve_scenes;"
          "import kfnet_tpu_torch.data.cambridge;"
          "import kfnet_tpu_torch.data.registry, kfnet_tpu_torch.data.pipeline;"
          "import kfnet_tpu_torch.data.fixture;"
          "import kfnet_tpu_torch.train.train_scoordnet;"
          "import kfnet_tpu_torch.train.train_oflownet;"
          "import kfnet_tpu_torch.train.train_kfnet;"
          "import kfnet_tpu_torch.eval.stats, kfnet_tpu_torch.eval.main;"
          "import kfnet_tpu_torch.tools.eval_poses;"
          "import kfnet_tpu_torch.tools.acceptance;"
          "import kfnet_tpu_torch.tools.soak, kfnet_tpu_torch.tools.protocol;"
          "import kfnet_tpu_torch.tools.export_release;"
          "import kfnet_tpu_torch.utils.tf1_import;"
          "import kfnet_tpu_torch.parallel;"
          "import kfnet_tpu_torch.parallel.mesh;"
          "import kfnet_tpu_torch.parallel.spatial;"
          "import kfnet_tpu_torch.utils.ocdbt;"
          "import kfnet_tpu_torch.kernels.winograd;"
          "import kfnet_tpu_torch.tools.cache_manifest;"
          f"bad = [m for m in {FORBIDDEN!r} if m in sys.modules];"
          "print(bad); sys.exit(1 if bad else 0)")
  res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
  assert res.returncode == 0, res.stdout + res.stderr


def test_nvcc_command_flags():
  cmd = _build.nvcc_command("nvcc", ["a.cu"], "out.so")
  assert "arch=compute_90a,code=sm_90a" in cmd
  for flag in ("-shared", "-fmad=false", "-O3", "-fPIC"):
    assert flag in cmd
  assert not any("fast_math" in c or "fast-math" in c for c in cmd)
  assert cmd[-1] == "a.cu" and cmd[cmd.index("-o") + 1] == "out.so"


def test_cache_key_follows_the_source(tmp_path):
  src = tmp_path / "k.cu"
  src.write_text("__global__ void k() {}\n")
  a = _build.cache_key([str(src)])
  assert _build.cache_key([str(src)]) == a
  src.write_text("__global__ void k() { }\n")
  assert _build.cache_key([str(src)]) != a
  assert _build.cache_key([str(src)], flags=("-O2",)) != _build.cache_key(
      [str(src)])


def test_build_goes_to_an_ignored_directory():
  # the repo's build/ (ignored by git), or a temporary directory when the
  # checkout cannot be written
  path = pathlib.Path(_build.build_dir())
  assert path in (ROOT / "build" / "kfnet_tpu_torch",
                  pathlib.Path(tempfile.gettempdir()) / "kfnet_tpu_torch_build")
  ignored = (ROOT / ".gitignore").read_text().split()
  assert "build/" in ignored


def test_missing_nvcc_raises(monkeypatch):
  monkeypatch.setenv("PATH", "")
  monkeypatch.delenv("CUDA_HOME", raising=False)
  if os.path.exists("/usr/local/cuda/bin/nvcc"):
    pytest.skip("this host has nvcc")
  with pytest.raises(RuntimeError, match="nvcc not found"):
    _build.find_nvcc()


def _run_smoke(cwd):
  env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # no device either way
  return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                        capture_output=True, text=True, timeout=180)


def test_chip_smoke_fails_without_cuda():
  res = _run_smoke(ROOT)
  assert res.returncode != 0
  assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
  shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
  res = _run_smoke(tmp_path)
  assert res.returncode != 0
  assert '"ok"' not in res.stdout


def test_every_kernel_source_is_in_the_checkout():
  from kfnet_tpu_torch.kernels import conv3x3, fused_filter
  for mod in (conv3x3, fused_filter):
    for src in mod.SOURCES:
      assert (ROOT / "kfnet_tpu_torch" / "kernels" / "csrc" / src).is_file()
  assert conv3x3.LIBRARY != fused_filter.LIBRARY
