"""The simulator's data parallelism over torch.distributed, on the CPU: two
processes joined by gloo run one Monte-Carlo job, each on its own batch
from its own generator, and all-reduce the counters. Both ranks must
report the same sums, equal to the two ranks' streams run one by one in
this process (rank 0's stream is the job without a group). Without a group
the mesh functions are the identity."""

import json
import os
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from polar_codes_torch.construction import frozen_bits  # noqa: E402
from polar_codes_torch.models.detectors import CRC8  # noqa: E402
from polar_codes_torch.models.encoder import PolarEncoder  # noqa: E402
from polar_codes_torch.models.fastssc import FastSSCDecoder  # noqa: E402
from polar_codes_torch.parallel import mesh as pmesh  # noqa: E402
from polar_codes_torch.sim.montecarlo import MonteCarlo, chunk_seed  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_LEN, K_LEN, BATCH, CHUNKS, SEED, EBN0 = 64, 40, 16, 3, 5, 1.0

_WORKER = r"""
import json, sys
import torch
torch.set_num_threads(1)
from polar_codes_torch.parallel.mesh import default_mesh, init_distributed
from polar_codes_torch.construction import frozen_bits
from polar_codes_torch.models.detectors import CRC8
from polar_codes_torch.models.encoder import PolarEncoder
from polar_codes_torch.models.fastssc import FastSSCDecoder
from polar_codes_torch.sim.montecarlo import MonteCarlo

rank, port = int(sys.argv[1]), sys.argv[2]
dev = init_distributed(f"tcp://localhost:{port}", world_size=2, rank=rank, device="cpu")
assert str(dev) == "cpu"
mesh = default_mesh(2, "cpu")
try:
    default_mesh(3, "cpu")
    raise SystemExit("default_mesh(3) accepted a group of 2")
except ValueError:
    pass
frozen = frozen_bits(%(n)d, %(k)d, 0.0)
enc = PolarEncoder(%(n)d, frozen, detector=CRC8(), device="cpu")
dec = FastSSCDecoder(%(n)d, frozen, detector=CRC8(), device="cpu")
mc = MonteCarlo(enc, dec, batch=%(b)d, mesh=mesh)
r = mc.run_job(%(e)r, %(b)d * 2 * %(c)d, seed=%(s)d)
print("COUNTS " + json.dumps({"mesh": [str(d) for d in mesh], "runs": r.runs,
      "errors": r.errors, "biterrors": r.biterrors, "reported": r.reportedErrors}), flush=True)
torch.distributed.destroy_process_group()
""" % {"n": N_LEN, "k": K_LEN, "b": BATCH, "c": CHUNKS, "s": SEED, "e": EBN0}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mc():
    frozen = frozen_bits(N_LEN, K_LEN, 0.0)
    return MonteCarlo(PolarEncoder(N_LEN, frozen, detector=CRC8(), device="cpu"),
                      FastSSCDecoder(N_LEN, frozen, detector=CRC8(), device="cpu"),
                      batch=BATCH)


def test_two_process_counter_all_reduce(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(script), str(rank), port], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        finally:
            p.kill()
        assert p.returncode == 0, f"worker failed:\n{out[-2000:]}\n{err[-2000:]}"
        outs.append(json.loads(out.split("COUNTS ", 1)[1]))
    assert outs[0] == outs[1]
    assert outs[0]["mesh"] == ["cpu", "cpu"]

    mc = _mc()
    alone = mc.run_job(EBN0, BATCH * CHUNKS, seed=SEED, warmup=False)  # rank 0's stream
    want = {"runs": alone.runs, "errors": alone.errors, "biterrors": alone.biterrors,
            "reported": alone.reportedErrors}
    esn0 = mc.esn0_linear(EBN0)
    for i in range(CHUNKS):  # rank 1's stream
        gen = torch.Generator().manual_seed(pmesh.distribute_keys(chunk_seed(SEED, i), 1))
        info, llr = mc._make_llr(gen, esn0)
        decoded, _, ok = mc.decoder.decode(llr)
        for k, v in mc._count(info, decoded, ok).items():
            want[k] += int(v)
    got = {k: outs[0][k] for k in want}
    assert got == want
    assert got["runs"] == 2 * BATCH * CHUNKS and 0 < got["errors"] < got["runs"]


def test_no_group_is_the_identity(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert pmesh.init_distributed(device="cpu") is None
    assert pmesh.default_mesh(None, "cpu") == [torch.device("cpu")]
    assert pmesh.default_mesh(1, "cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="process group has 1"):
        pmesh.default_mesh(2, "cpu")
    assert pmesh.distribute_keys(1234) == 1234
    assert pmesh.distribute_keys(1234, 1) != pmesh.distribute_keys(1234, 2)

    def step():
        return {"runs": torch.tensor(3)}

    assert pmesh.sharded_counter_step(step) is step
