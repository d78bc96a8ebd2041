"""Build the port's CUDA sources with ``nvcc``, and its host C++ sources
(the data path's PNG decoder and batch loader, ``data/csrc``) with the
host's C++ compiler, into shared libraries with a plain C interface,
loaded with ``ctypes``.

No PyTorch headers are compiled, so a build takes seconds. A library is
built at first use and cached under a name that carries a hash of its
sources and flags, in ``<repo>/build/kfnet_tpu_torch/`` (or, where that
cannot be written, a directory under ``tempfile.gettempdir()``). A failed
build raises with the compiler's output; nothing falls back.
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
# a host library is built on the host that runs it, for no particular
# CPU (no -march=native); the data library links zlib for PNG's inflate
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall")
HOST_LIBS = ("-lz",)


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


def find_cxx() -> str:
  """The host C++ compiler: $CXX, then ``g++``, then ``c++`` on PATH."""
  for c in (os.environ.get("CXX"), "g++", "c++"):
    path = c and shutil.which(c)
    if path:
      return path
  raise RuntimeError("no C++ compiler ($CXX, g++ or c++ on PATH): the "
                     "data path's host library cannot be built")


def host_command(cxx: str, sources, output: str, libs=HOST_LIBS) -> list:
  return [cxx, *HOST_FLAGS, "-o", output, *sources, *libs]


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


def _lib_path(name: str, sources, host: bool = False,
              libs=HOST_LIBS) -> tuple[list, str]:
  """Absolute sources (names relative to ``CSRC``; absolute paths stay as
  they are) and the cached library's path."""
  sources = [os.path.join(CSRC, s) for s in sources]
  flags = HOST_FLAGS + tuple(libs) if host else NVCC_FLAGS
  return sources, os.path.join(build_dir(),
                               f"lib{name}-{cache_key(sources, flags)}.so")


def build_libraries(specs, host: bool = False, libs=HOST_LIBS) -> None:
  """Build every library of ``specs`` ((name, sources) pairs) that is not
  on disk yet, one compiler process each (``nvcc``, or the host's C++
  compiler where ``host``, linking ``libs``), all started together."""
  jobs = []
  try:
    for name, sources in specs:
      srcs, lib_path = _lib_path(name, sources, host, libs)
      if os.path.exists(lib_path):
        continue
      tmp = f"{lib_path}.{os.getpid()}.tmp"
      cmd = (host_command(find_cxx(), srcs, tmp, libs) if host
             else nvcc_command(find_nvcc(), srcs, tmp))
      jobs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True),
                   cmd, tmp, lib_path))
    for proc, cmd, tmp, lib_path in jobs:
      tool = os.path.basename(cmd[0])
      try:
        _, err = proc.communicate(timeout=NVCC_TIMEOUT_S)
      except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"{tool} timed out after {NVCC_TIMEOUT_S} s: "
                           f"{' '.join(cmd)}") from e
      if proc.returncode != 0:
        raise RuntimeError(f"{tool} failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{err}")
      os.replace(tmp, lib_path)  # atomic: a reader never sees a partial file
  finally:
    for proc, *_ in jobs:  # none outlives a failure
      if proc.poll() is None:
        proc.kill()
        proc.wait()


def load_library(name: str, sources, host: bool = False,
                 libs=HOST_LIBS) -> ctypes.CDLL:
  """Build (once per source hash on disk) and load ``sources`` as
  ``lib<name>-<hash>.so``; a host library links ``libs``. Callers keep the
  loaded library."""
  build_libraries([(name, sources)], host, libs)
  return ctypes.CDLL(_lib_path(name, sources, host, libs)[1])
