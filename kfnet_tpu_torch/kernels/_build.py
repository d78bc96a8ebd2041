"""Build the port's CUDA sources with ``nvcc`` into shared libraries with a
plain C interface, loaded with ``ctypes``.

No PyTorch headers are compiled, so a build takes seconds. A library is
built at first use and cached under a name that carries a hash of its
sources and flags, in ``<repo>/build/kfnet_tpu_torch/`` (or, where that
cannot be written, a directory under ``tempfile.gettempdir()``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# sm_90a: Hopper with its architecture-specific features. -fmad=false and
# no --use_fast_math: every multiply and add rounds on its own, as in the
# plain PyTorch version, so the two agree bit for bit.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
NVCC_TIMEOUT_S = 240


def find_nvcc() -> str:
  """``nvcc`` on PATH, then in $CUDA_HOME/bin, then /usr/local/cuda/bin."""
  candidates = [shutil.which("nvcc")]
  if os.environ.get("CUDA_HOME"):
    candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
  candidates.append("/usr/local/cuda/bin/nvcc")
  for c in candidates:
    if c and os.path.isfile(c) and os.access(c, os.X_OK):
      return c
  raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or in "
                     "/usr/local/cuda/bin: the CUDA kernels cannot be built")


def nvcc_command(nvcc: str, sources, output: str) -> list:
  return [nvcc, *NVCC_FLAGS, "-o", output, *sources]


def cache_key(sources, flags=NVCC_FLAGS) -> str:
  """Hash of the sources' bytes and the flags: a changed source or flag
  gives a new library name, so a stale build is never loaded."""
  h = hashlib.sha256()
  for path in sources:
    h.update(os.path.basename(path).encode())
    with open(path, "rb") as f:
      h.update(f.read())
  h.update(" ".join(flags).encode())
  return h.hexdigest()[:16]


def _writable(path: str) -> bool:
  try:
    os.makedirs(path, exist_ok=True)
    probe = tempfile.NamedTemporaryFile(dir=path, delete=True)
    probe.close()
    return True
  except OSError:
    return False


def build_dir() -> str:
  path = os.path.join(_REPO, "build", "kfnet_tpu_torch")
  if _writable(path):
    return path
  path = os.path.join(tempfile.gettempdir(), "kfnet_tpu_torch_build")
  os.makedirs(path, exist_ok=True)
  print(f"kfnet_tpu_torch: {_REPO}/build is not writable; building in "
        f"{path}", flush=True)
  return path


def load_library(name: str, sources) -> ctypes.CDLL:
  """Build (once per source hash on disk) and load ``sources`` as
  ``lib<name>-<hash>.so``. Callers keep the loaded library."""
  sources = [os.path.join(CSRC, s) for s in sources]
  key = cache_key(sources)
  out_dir = build_dir()
  lib_path = os.path.join(out_dir, f"lib{name}-{key}.so")
  if not os.path.exists(lib_path):
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = nvcc_command(find_nvcc(), sources, tmp)
    try:
      res = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=NVCC_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
      raise RuntimeError(f"nvcc timed out after {NVCC_TIMEOUT_S} s: "
                         f"{' '.join(cmd)}\n{e.stderr or ''}") from e
    if res.returncode != 0:
      raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}"
                         f"\n{res.stderr}")
    os.replace(tmp, lib_path)  # atomic: a reader never sees a partial file
  return ctypes.CDLL(lib_path)
