"""The port's CUDA sources, compiled for the host and run on the CPU.

There is no GPU or nvcc here, so the kernels' own arithmetic would
otherwise go untested until a run on the card.  g++ compiles each
`mvsmplfitting_tpu_torch/csrc/*.cu` against `tests/cuda_host/
cuda_runtime.h`, which runs every block's threads as std::threads with
barriers for `__syncthreads`/`__syncwarp`; the C entry point is then
called through the wrappers' own `bind`/`call` on CPU tensors and held
against the plain PyTorch version at the kernel tolerances (RTOL 3e-5 /
ATOL 1e-5; the VPoser D block at 3e-4 / 3e-4 max|D|).  This checks the
arithmetic and indexing, not the GPU's memory model or timing.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mvsmplfitting_tpu_torch.models import vposer as V
from mvsmplfitting_tpu_torch.ops import cuda_build
from mvsmplfitting_tpu_torch.ops import joint_kernel as JK
from mvsmplfitting_tpu_torch.ops import vposer_kernel as VK

from torch_port_helpers import port_assets, rand_joint_inputs, vposer_pair

STUB_DIR = os.path.join(os.path.dirname(__file__), "cuda_host")
LAUNCH = re.compile(r"(\w+)<<<(.*?),(.*?),.*?>>>\((.*?)\);", re.S)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the host")
    out_dir = tmp_path_factory.mktemp("cuda_host")
    libs = {}
    for name in cuda_build.KERNEL_SOURCES:
        src = (cuda_build.CSRC_DIR / f"{name}.cu").read_text()
        src, n = LAUNCH.subn(r"emu_launch(\2, \3, [&] { \1(\4); });", src)
        assert n == 1, f"{name}: expected one kernel launch, found {n}"
        cpp = out_dir / f"{name}.cpp"
        cpp.write_text(src)
        so = out_dir / f"lib{name}.so"
        subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                        "-pthread", "-I", STUB_DIR, "-o", str(so), str(cpp)],
                       check=True, timeout=300, capture_output=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


@pytest.mark.parametrize("model_type", ["smpl", "smpllsp"])
def test_joint_jacobian_source_on_host(host_libs, model_type):
    jm = port_assets(model_type).joint_model
    theta, betas, scale = (torch.from_numpy(a) for a in rand_joint_inputs(
        np.random.default_rng(7), 3))
    fn = JK.bind(host_libs["joint_jacobian"])
    gj, gb = JK.call(fn, JK.kernel_tables(jm, torch.device("cpu")), theta,
                     betas, scale, None)
    wj, wb = JK.joint_jacobian_plain(jm, theta, betas, scale)
    torch.testing.assert_close(gj, wj, rtol=3e-5, atol=1e-5)
    for k in wb:
        torch.testing.assert_close(gb[k], wb[k], rtol=3e-5, atol=1e-5,
                                   msg=f"{model_type} block {k}")


@pytest.mark.parametrize("sigma", [0.6, 1e-3])
def test_vposer_tail_source_on_host(host_libs, sigma):
    _, tw = vposer_pair()
    z = torch.from_numpy(np.random.default_rng(8).normal(
        0, sigma, (5, 32)).astype(np.float32))
    o, Do = V.mlp_head(tw, z)
    o, Do = o.contiguous(), Do.contiguous()
    aa1, D1 = VK.call(VK.bind(host_libs["vposer_tail"]), o, Do, None)
    aa0, D0 = VK.tail_plain(o, Do)
    torch.testing.assert_close(aa1, aa0, rtol=3e-5, atol=1e-5)
    sc = max(D0.abs().max().item(), 1.0)
    torch.testing.assert_close(D1, D0, rtol=3e-4, atol=3e-4 * sc)
