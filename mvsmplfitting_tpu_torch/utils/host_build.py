"""Build the port's host C++ sources with g++ and load them with ctypes.

Each `csrc/<name>.cpp` compiles into its own shared library under
`build/host/` at the repository root (listed in `.gitignore`), named by a
hash of its source, the `csrc/` headers it includes and its flags, so an
edited source or header is rebuilt.  Nothing
builds at import time: the first call that needs a library builds and
loads it, and a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional, Sequence

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR.parent.parent / "build" / "host"
GXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")
_LOCAL_INCLUDE = re.compile(rb'^#include "([^"]+)"', re.M)


def compiler() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        if name and shutil.which(name):
            return shutil.which(name)
    raise RuntimeError("no C++ compiler found (tried $CXX, g++, c++): the "
                       "port's host libraries are built from csrc/*.cpp")


class HostLibrary:
    """`csrc/<name>.cpp` as a ctypes library; `declare(lib)` sets the
    argument and result types of its entry points once it is loaded."""

    def __init__(self, name: str, declare: Callable[[ctypes.CDLL], None],
                 extra_flags: Sequence[str] = ()):
        self.name = name
        self.source = CSRC_DIR / f"{name}.cpp"
        self.flags = GXX_FLAGS + tuple(extra_flags)
        self._declare = declare
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None

    def path(self) -> Path:
        text = self.source.read_bytes()
        h = hashlib.sha1(text)
        for header in sorted(set(_LOCAL_INCLUDE.findall(text))):
            h.update((CSRC_DIR / header.decode()).read_bytes())
        h.update(" ".join(self.flags).encode())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:12]}.so"

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is not None:
                return self._lib
            out = self.path()
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                proc = subprocess.run(
                    [compiler(), *self.flags, "-o", str(tmp),
                     str(self.source)], capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"building csrc/{self.source.name} failed:\n"
                        + proc.stdout + proc.stderr)
                os.replace(tmp, out)
            lib = ctypes.CDLL(str(out))
            self._declare(lib)
            self._lib = lib
            return lib
