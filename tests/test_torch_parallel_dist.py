"""The port's scale-out layer across processes: 2 and 4 gloo ranks on the CPU.

The test spawns this file as a worker (``python tests/test_torch_parallel_dist.py
--worker``), one process a rank, joined on 127.0.0.1 through torchrun's
variables.  The parent makes the inputs from a numpy seed and computes the
expected values with the JAX package's oracle and limb codecs, and writes
both as ``.npy`` files.  Each worker imports only torch and the port, runs:

- ``ntt_sharded`` natural and ``transposed_out=True`` against the expected
  blocks, both inverse round trips, the coset forms, ``ntt_batch_sharded``,
  at n = 2^8;
- ``msm_g1_sharded`` over 64 points, one chunk a rank (GLV, window 5);

and exits 0 only where every rank's limbs equal the expected ones and, for
the MSM's point, every other rank's.  Each worker is killed after 180 s.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

# One intra-op thread, in the test process and in each rank's worker (which
# runs this file): the port's CPU path is thousands of tiny tensor ops.
torch.set_num_threads(1)

LOG_N = 8
MSM_N = 64
MSM_WINDOW = 5
SEED = 0xD157
TIMEOUT_S = 180
SHIFT = 7          # the coset shift: Fr's multiplicative generator


def _worker(data_dir: str) -> int:
    import torch.distributed as dist

    from tpu_bls12_381_torch import convert
    from tpu_bls12_381_torch.curves import g1
    from tpu_bls12_381_torch.parallel import (coset_intt_sharded, coset_ntt_sharded,
                                              default_mesh, init_distributed,
                                              intt_sharded, msm_g1_sharded,
                                              ntt_batch_sharded, ntt_sharded)
    from tpu_bls12_381_torch.parallel.mesh import local_block
    from tpu_bls12_381_torch.parallel.msm import shard_msm_inputs

    def npy(name):
        return np.load(os.path.join(data_dir, f"{name}.npy"))

    def load(name):
        return torch.from_numpy(npy(name))

    assert init_distributed(backend="gloo") is True
    assert init_distributed() is True                  # a second call
    mesh = default_mesh(device="cpu")
    failures = []
    try:
        n = 1 << LOG_N
        blk = local_block(mesh, n)
        x = load("x")[blk].contiguous()
        checks = {}
        y = ntt_sharded(x, mesh)
        checks["ntt natural"] = torch.equal(y, load("ntt")[blk])
        yt = ntt_sharded(x, mesh, transposed_out=True)
        checks["ntt transposed"] = torch.equal(yt, load("ntt_t")[blk])
        checks["intt natural"] = torch.equal(intt_sharded(y, mesh), x)
        checks["intt transposed"] = torch.equal(intt_sharded(yt, mesh, transposed_in=True), x)
        yc = coset_ntt_sharded(x, mesh, SHIFT)
        checks["coset_ntt"] = torch.equal(yc, load("coset")[blk])
        ytc = coset_ntt_sharded(x, mesh, SHIFT, transposed_out=True)
        checks["coset round trips"] = (
            torch.equal(coset_intt_sharded(yc, mesh, SHIFT), x)
            and torch.equal(coset_intt_sharded(ytc, mesh, SHIFT, transposed_in=True), x))
        bx = load("batch_x")
        bblk = local_block(mesh, bx.shape[1], 1)
        checks["ntt_batch_sharded"] = torch.equal(
            ntt_batch_sharded(bx[bblk].contiguous(), mesh), load("batch_y")[bblk])

        A = convert.affine_from_numpy(npy("msm_x"), npy("msm_y"), npy("msm_inf"),
                                      device="cpu")
        sc_c, A_c = shard_msm_inputs(load("msm_scalars"), A, mesh)
        P = msm_g1_sharded(sc_c, A_c, mesh, window_bits=MSM_WINDOW, glv=True)
        mine = torch.stack(P)                           # (3, 24)
        every = [torch.empty_like(mine) for _ in range(mesh.size)]
        dist.all_gather(every, mine)
        checks["msm ranks agree"] = all(torch.equal(e, mine) for e in every)
        want = [int(v) for v in npy("msm_want")]
        checks["msm value"] = list(g1.jacobian_to_ints(
            tuple(c[:, None] for c in P))[0]) == want
        failures = [k for k, ok in checks.items() if not ok]
    finally:
        dist.destroy_process_group()
    print(f"rank {mesh.rank} of {mesh.size}: " + ("OK" if not failures
                                                   else f"FAILED {failures}"), flush=True)
    return 1 if failures else 0


def _expected(tmp_path, world: int) -> None:
    """The inputs from a numpy seed and the expected values from the JAX
    package (its oracle and limb codecs), as .npy files under ``tmp_path``."""
    from tpu_bls12_381 import oracle
    from tpu_bls12_381.constants import FQ_MODULUS, FR_MODULUS
    from tpu_bls12_381.fields.limbs import ints_to_limbs
    from tpu_bls12_381.parallel.ntt import split_sizes

    rng = np.random.default_rng(SEED + world)
    R, rmont = FR_MODULUS, (1 << 256) % FR_MODULUS

    def fr_ints(n):
        return [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]

    def fr_mont(vals):
        return ints_to_limbs([v * rmont % R for v in vals], 16).astype(np.int32)

    n = 1 << LOG_N
    vals = fr_ints(n)
    nat = oracle.ntt(vals)
    nA, nB = split_sizes(LOG_N, world)
    trans = [nat[k2 + nB * k1] for k2 in range(nB) for k1 in range(nA)]
    B = 2 * world
    rows = [fr_ints(n) for _ in range(B)]
    arrays = {
        "x": fr_mont(vals), "ntt": fr_mont(nat), "ntt_t": fr_mont(trans),
        "coset": fr_mont(oracle.coset_ntt(vals, SHIFT)),
        "batch_x": np.stack([fr_mont(r) for r in rows], axis=1),
        "batch_y": np.stack([fr_mont(oracle.ntt(r)) for r in rows], axis=1),
    }
    G = oracle.g1_generator()
    pts = [oracle.jac_to_affine(oracle.scalar_mul(int(k), G, oracle.FQ_OPS), oracle.FQ_OPS)
           for k in rng.integers(1, 1 << 40, size=MSM_N)]
    scalars = fr_ints(MSM_N)
    qmont = (1 << 384) % FQ_MODULUS
    arrays.update({
        "msm_scalars": fr_mont(scalars),
        "msm_x": ints_to_limbs([p[0] * qmont % FQ_MODULUS for p in pts], 24).astype(np.int32),
        "msm_y": ints_to_limbs([p[1] * qmont % FQ_MODULUS for p in pts], 24).astype(np.int32),
        "msm_inf": np.zeros(MSM_N, dtype=bool),
        "msm_want": np.array([str(v) for v in oracle.jac_to_affine(
            oracle.msm(scalars, pts, oracle.FQ_OPS), oracle.FQ_OPS)]),
    })
    for name, arr in arrays.items():
        np.save(tmp_path / f"{name}.npy", arr)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_world(tmp_path, world: int) -> None:
    _expected(tmp_path, world)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (root, os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(tmp_path)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(world)]
    outs = []
    try:
        for pr in procs:
            out, _ = pr.communicate(timeout=TIMEOUT_S)
            outs.append(out.decode())
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{world} gloo ranks did not finish in {TIMEOUT_S} s")
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for r, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
        assert f"rank {r} of {world}: OK" in out, out[-3000:]


def test_two_gloo_ranks_agree_with_the_jax_package(tmp_path):
    _run_world(tmp_path, 2)


def test_four_gloo_ranks_agree_with_the_jax_package(tmp_path):
    _run_world(tmp_path, 4)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.exit(_worker(sys.argv[2]))
