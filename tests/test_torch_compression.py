"""The port's error-feedback int8 all-reduce (``parallel.compression``)
against the reference's.  The port runs at gloo world size 2 in a
subprocess (two CPU processes, ``make_host_mesh(device="cpu")``), each
rank holding the same numpy-seeded gradients; the reference runs in this
process on a one-device mesh, where replicated gradients give the same
formula.  Means and residuals agree to 1 ulp, and the reference test's
bound (error and reconstruction within 0.75 x scale) holds for both."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.parallel.compression import (_quantize as ref_quantize,
                                        init_residual as ref_init,
                                        make_compressed_allreduce as ref_make)

ROOT = Path(__file__).resolve().parents[1]

GRADS = textwrap.dedent("""
    import numpy as np
    def grads(seed):
        rng = np.random.default_rng(seed)
        return {"w": rng.standard_normal((32, 32)).astype(np.float32),
                "layers": {"b": (rng.standard_normal(48) * 1e-3
                                 ).astype(np.float32),
                           "c": np.zeros((4, 4), np.float32),
                           "d": (rng.standard_normal((8, 16)) * 40.0
                                 ).astype(np.float32)}}
""")
exec(GRADS)

WORKER = GRADS + textwrap.dedent("""
    import os, sys, socket
    import torch, torch.distributed as dist
    import torch.multiprocessing as mp

    def flat(tree, pre=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, pre + k + "."))
            else:
                out[pre + k] = v.numpy()
        return out

    def worker(rank, port, path):
        os.environ.update(RANK=str(rank), WORLD_SIZE="2",
                          MASTER_ADDR="localhost", MASTER_PORT=str(port))
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.parallel.compression import (
            compressed_psum, init_residual, make_compressed_allreduce)
        mesh = make_host_mesh((2,), ("data",), device="cpu")
        g = {k: (torch.from_numpy(v) if not isinstance(v, dict) else
                 {kk: torch.from_numpy(vv) for kk, vv in v.items()})
             for k, v in grads(0).items()}
        f = make_compressed_allreduce(mesh, "data")
        mean, res = f(g, init_residual(g))
        # a second step carries the residual
        mean2, res2 = f(g, res)
        ps = compressed_psum(g["w"], mesh.get_group("data"))
        if rank == 0:
            out = {"mean." + k: v for k, v in flat(mean).items()}
            out.update({"res." + k: v for k, v in flat(res).items()})
            out.update({"mean2." + k: v for k, v in flat(mean2).items()})
            out.update({"res2." + k: v for k, v in flat(res2).items()})
            out["psum"] = ps.numpy()
            np.savez(path, **out)
        dist.destroy_process_group()

    if __name__ == "__main__":
        s = socket.socket(); s.bind(("localhost", 0))
        port = s.getsockname()[1]; s.close()
        mp.spawn(worker, args=(port, sys.argv[1]), nprocs=2)
""")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    d = tmp_path_factory.mktemp("compress")
    script = d / "worker.py"
    script.write_text(WORKER)
    path = d / "out.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(script), str(path)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(path))


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "."))
        else:
            out[pre + k] = np.asarray(v)
    return out


def _reference():
    mesh = jax.make_mesh((1,), ("data",))
    f = ref_make(mesh, "data")
    g = jax.tree_util.tree_map(jnp.asarray, grads(0))
    mean, res = f(g, ref_init(g))
    mean2, res2 = f(g, res)
    return _flat(mean), _flat(res), _flat(mean2), _flat(res2)


def test_mean_and_residual_match_reference_to_one_ulp(port):
    for name, tree in zip(("mean", "res", "mean2", "res2"), _reference()):
        for k, ref in tree.items():
            got = port[f"{name}.{k}"]
            assert got.dtype == ref.dtype and got.shape == ref.shape
            np.testing.assert_array_max_ulp(got, ref, maxulp=1)


def test_error_within_the_reference_bound(port):
    """The reference test's check: every rank holds the same gradients,
    so the mean should give them back within 0.75 x scale, and residual
    + mean reproduces them within the same bound."""
    g = _flat(grads(0))
    for k, x in g.items():
        scale = max(float(np.max(np.abs(x))), 1e-12) / 127.0
        mean, res = port[f"mean.{k}"], port[f"res.{k}"]
        assert float(np.max(np.abs(mean - x))) <= 0.75 * scale + 1e-6
        assert float(np.max(np.abs(res + mean - x))) <= 0.75 * scale + 1e-6


def test_compressed_psum_sums_the_ranks(port):
    """Two ranks with the same tensor: the int32 sum of the int8 payload
    times the mean scale is twice the dequantized tensor."""
    import torch
    from repro_torch.parallel.compression import _quantize
    x = torch.from_numpy(grads(0)["w"])
    q, s = _quantize(x)
    np.testing.assert_array_equal(port["psum"],
                                  (2 * q.to(torch.int32)).float() * s)
    rq, rs = ref_quantize(jnp.asarray(grads(0)["w"]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
