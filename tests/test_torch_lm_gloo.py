"""The LM side of multi-GPU across processes: 2 gloo processes of 2 shard
slots each ≡ 1 process of the same 4 slots, bit for bit, for

* ``moe_ep``: true EP on (1, 4), the F split on (1, 4), the stationary
  layout on (2, 2);
* the length-sharded decode: the batch whole on (1, 4), the batch over
  ``data`` on (2, 2);
* ``compressed_psum`` over 4 data slots, each its own gradient, 2 steps;
* ``gpipe`` over 4 stages.

Every cross-slot combine is an all-gather added in mesh order, so which
process holds a slot changes nothing. Each run is a subprocess (``python
-c``); the two processes meet over ``tcp://localhost`` on a free port.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
if world > 1:
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
from repro_torch.configs import ARCHS, reduced
from repro_torch.launch.mesh import make_mesh, set_local_slots
from repro_torch.launch.pipeline import gpipe, stack_stage_params
from repro_torch.models import attention, moe
from repro_torch.optim.compression import compressed_psum

set_local_slots(4 // world)
cpu = torch.device("cpu")
res = {}
mesh14 = make_mesh((1, 4), ("data", "model"), device=cpu)
mesh22 = make_mesh((2, 2), ("data", "model"), device=cpu)

for label, arch, over, mesh, stationary in (
    ("ep14", "mixtral-8x7b", {"capacity_factor": 1.0}, mesh14, False),
    ("f14", "mixtral-8x7b", {"n_experts": 2, "capacity_factor": 1.0}, mesh14, False),
    ("st22", "llama4-scout-17b-a16e", {"capacity_factor": 1.0}, mesh22, True),
):
    cfg = reduced(ARCHS[arch], **over)
    p = moe.init_moe(torch.Generator().manual_seed(1), cfg)
    x = torch.randn((4, 8, cfg.d_model), generator=torch.Generator().manual_seed(2))
    moe.set_ep_mesh(mesh, ("data",), stationary=stationary)
    y, aux = moe.moe_block(p, x, cfg)
    moe.set_ep_mesh(None, ())
    res[label + "/y"], res[label + "/aux"] = y.numpy(), aux.numpy()

g = torch.Generator().manual_seed(3)
q, k, v = (torch.randn(s, generator=g) for s in ((4, 1, 4, 16), (4, 32, 2, 16), (4, 32, 2, 16)))
q_pos, k_pos = torch.full((4, 1), 40, dtype=torch.int32), torch.arange(32, dtype=torch.int32)[None].expand(4, 32) + 3
valid = torch.rand((4, 32), generator=g) < 0.9
for label, mesh, baxes, saxes in (("dec14", mesh14, None, ("data", "model")), ("dec22", mesh22, "data", ("model",))):
    attention.set_decode_context(mesh, baxes, saxes)
    res[label] = attention.dispatch_attend_decode(q, k, v, q_pos, k_pos, valid, window=20).numpy()
    attention.set_decode_context(None, None, ())

flat = make_mesh((4,), ("data",), device=cpu)
mine = flat.local_indices()
resid = [{"w": torch.zeros(300, 7), "b": torch.zeros(5)} for _ in mine]
for step in range(2):
    grads = [{"w": torch.randn((300, 7), generator=torch.Generator().manual_seed(10 * step + i)),
              "b": torch.randn((5,), generator=torch.Generator().manual_seed(100 + 10 * step + i))} for i in mine]
    red, resid = compressed_psum(grads, flat, "data", resid)
    res[f"cps{step}/w"], res[f"cps{step}/b"] = red[0]["w"].numpy(), red[0]["b"].numpy()
    for i, r in zip(mine, resid):
        res[f"cps{step}/res{i}"] = r["w"].numpy()

stages = make_mesh((4,), ("stage",), device=cpu)
ws = [torch.randn((16, 16), generator=torch.Generator().manual_seed(20 + i)) / 4 for i in range(8)]
def stage_fn(sp, x):
    for w in sp:
        x = torch.tanh(x @ w)
    return x
xm = torch.randn((6, 3, 16), generator=torch.Generator().manual_seed(30))
res["gpipe"] = gpipe(stages, "stage", stage_fn, 6)(stack_stage_params(ws, 4), xm).numpy()

if rank == 0:
    np.savez(out, **res)
elif world > 1:
    np.savez(out + f".rank{rank}.npz", **res)
if world > 1:
    dist.barrier()
    dist.destroy_process_group()
print("DONE", rank)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(world: int, out: str) -> None:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(world), port, out], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=300)
            logs.append((p.returncode, so[-2000:], se[-3000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(rc == 0 for rc, _, _ in logs), logs


def test_two_gloo_processes_equal_one_process_bit_for_bit(tmp_path):
    one, two = str(tmp_path / "one.npz"), str(tmp_path / "two.npz")
    _run(1, one)
    _run(2, two)
    a, b = np.load(one), np.load(two)
    rank1 = np.load(two + ".rank1.npz")
    local_res = {k for k in rank1.files if "/res" in k}
    assert local_res and not (local_res & set(b.files))  # each process kept its own slots' residuals
    assert set(a.files) == set(b.files) | local_res
    for key in b.files:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for key in local_res:
        np.testing.assert_array_equal(a[key], rank1[key], err_msg=key)
    for key in rank1.files:  # rank 1 holds the same global answers
        if key not in local_res:
            np.testing.assert_array_equal(rank1[key], b[key], err_msg=key)
