"""Builds the port's native code at first use, into ``csrc/build/``.

CUDA kernels: each ``<name>.cu`` in this directory compiles into its own
shared library with a plain C interface, for ``sm_90a`` (Hopper), loaded
with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/lib<name>-<digest>.so <name>.cu

C extensions: ``build_extension(name)`` compiles ``<name>.c`` (the V1
JSON codec, ``tensorjson.c``) with the host C compiler against the
running interpreter's ``Python.h`` into a CPython extension module:

    cc -O3 -shared -fPIC -I<python include> \
       -o build/_<name>-<digest><EXT_SUFFIX> <name>.c

Each file name carries a digest of the source and the flags (for a kernel
also of every shared ``*.cuh`` header here; for an extension, of the
interpreter's include directory and ABI suffix), so an edited source or
header rebuilds and an unchanged one is reused.  Nothing here runs
at import time: the first wrapper call builds (or ``build_all`` builds
every kernel at once, one nvcc process per source, all started together).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig
import tempfile
import threading
from typing import Dict, List, Optional

CSRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(CSRC_DIR, "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
CC_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build this
# process ran, by kernel name.
build_logs: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    pass


def sources() -> List[str]:
    """Kernel names: one per ``.cu`` file in this directory."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def find_nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.path.exists(default) else None


def headers() -> List[str]:
    """The shared headers (``*.cuh``) in this directory."""
    return sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))


def library_path(name: str) -> str:
    """Where kernel ``name`` is built: the digest covers its source, every
    shared header (a kernel may include any of them) and the flags."""
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read())
    for header in headers():
        with open(os.path.join(CSRC_DIR, header), "rb") as f:
            digest.update(header.encode() + b"\0" + f.read())
    digest.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"lib{name}-{digest.hexdigest()[:16]}.so")


def nvcc_command(nvcc: str, name: str, out: str) -> List[str]:
    return [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-o", out,
            os.path.join(CSRC_DIR, f"{name}.cu")]


def build_all(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Compiles every missing kernel library in parallel; returns the
    library path of each name.  Raises KernelBuildError on any failure."""
    names = sources() if names is None else names
    targets = {n: library_path(n) for n in names}
    missing = [n for n in names if not os.path.exists(targets[n])]
    if not missing:
        return targets
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels build only on a machine with the CUDA toolkit")
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for n in missing:
        # Build under a private name and rename into place, so a
        # concurrent build never loads a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        procs[n] = (tmp, subprocess.Popen(
            nvcc_command(nvcc, n, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failures = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_logs[n] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, targets[n])
    if failures:
        raise KernelBuildError("kernel build failed: " + "\n".join(failures))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all([name])[name])
            _libraries[name] = lib
        return lib


def find_cc() -> Optional[str]:
    return shutil.which("cc") or shutil.which("gcc")


def extension_path(name: str) -> str:
    include = sysconfig.get_paths()["include"]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    with open(os.path.join(CSRC_DIR, f"{name}.c"), "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(CC_FLAGS + [include, suffix]).encode())
    return os.path.join(BUILD_DIR,
                        f"_{name}-{digest.hexdigest()[:16]}{suffix}")


def build_extension(name: str) -> str:
    """Compiles ``<name>.c`` into a CPython extension module unless it is
    built already; returns its path.  Raises KernelBuildError when there
    is no C compiler or no ``Python.h``, or the compile fails."""
    target = extension_path(name)
    with _lock:
        if os.path.exists(target):
            return target
        cc = find_cc()
        include = sysconfig.get_paths()["include"]
        if cc is None:
            raise KernelBuildError(
                f"no C compiler (cc or gcc on PATH) to build {name}.c")
        if not os.path.exists(os.path.join(include, "Python.h")):
            raise KernelBuildError(
                f"Python.h not found under {include}: {name}.c builds "
                "only where the interpreter's headers are installed")
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run(
            [cc, *CC_FLAGS, f"-I{include}", "-o", tmp,
             os.path.join(CSRC_DIR, f"{name}.c")],
            capture_output=True, text=True, timeout=300)
        build_logs[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise KernelBuildError(
                f"{name}.c ({cc} exit {proc.returncode}):\n"
                f"{build_logs[name]}")
        os.replace(tmp, target)
        return target
