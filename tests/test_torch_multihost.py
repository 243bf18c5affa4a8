"""`lz4_tpu_torch.parallel.multihost` against the JAX package's frames: the
range partition, two processes over gloo on localhost (``device="cpu"``,
each with its own timeout) whose frames equal the JAX package's
single-process frames, independent and chained, and the single-process
semantics of the distributed decode (the cases of tests/test_multihost.py)."""

import os
import random
import socket
import subprocess
import sys

import pytest

from lz4_tpu import frame as jframe
from lz4_tpu.frame.header import LZ4FormatError as JaxLZ4FormatError
from lz4_tpu.parallel import multihost as jmh
from lz4_tpu_torch.frame import EncoderSettings, LZ4FormatError
from lz4_tpu_torch.parallel import multihost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n_blocks", [1, 2, 7, 16, 31])
@pytest.mark.parametrize("nproc", [1, 2, 3, 8])
def test_local_block_range_partitions(n_blocks, nproc):
    ranges = [multihost.local_block_range(n_blocks, p, nproc) for p in range(nproc)]
    assert ranges == [jmh.local_block_range(n_blocks, p, nproc) for p in range(nproc)]
    covered = [b for a, z in ranges for b in range(a, z)]
    assert covered == list(range(n_blocks))


def test_init_from_env_without_a_coordinator(monkeypatch):
    monkeypatch.delenv("LZ4TPU_COORDINATOR", raising=False)
    assert multihost.init_from_env() is False
    assert multihost.broadcast_dictionary(b"abc") == b"abc"


_WORKER = r"""
import os, random, sys
sys.path.insert(0, os.environ["LZ4TPU_TEST_ROOT"])
sys.modules["jax"] = None  # the port runs without JAX
import torch.distributed as dist
from lz4_tpu_torch.frame import EncoderSettings
from lz4_tpu_torch.parallel import multihost

assert multihost.init_from_env()
rank = dist.get_rank()
assert dist.get_world_size() == 2
d = multihost.broadcast_dictionary(b"shared-window-" * 100 if rank == 0 else None)
assert d == b"shared-window-" * 100, (rank, len(d))
data = random.Random(77).randbytes(9_000) * 40  # 360 KB, compressible
blob = multihost.compress_distributed(data, block_size=65536, level=0, device="cpu")
assert multihost.decompress_distributed(blob, device="cpu") == data
# a malformed last block (owned by process 1) raises on both processes
from lz4_tpu_torch.block import LZ4Error
from lz4_tpu_torch.frame.api import _scan_frame
off = _scan_frame(blob).blocks[-1][0]
bad = blob[:off] + b"\x10a\x00\x00\x00" + blob[off + 5:]
try:
    multihost.decompress_distributed(bad, device="cpu")
    raise SystemExit("a malformed block decoded")
except LZ4Error:
    pass
chained = multihost.compress_distributed(
    data, settings=EncoderSettings(chain_blocks=True, block_size=65536), device="cpu")
out = os.environ["LZ4TPU_TEST_OUT"] + f".{rank}"
with open(out, "wb") as f:
    f.write(blob)
with open(out + ".chained", "wb") as f:
    f.write(chained)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_frame(tmp_path):
    port = _free_port()
    out = str(tmp_path / "frame")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER],
            env=dict(os.environ, LZ4TPU_TEST_ROOT=ROOT,
                     LZ4TPU_COORDINATOR=f"127.0.0.1:{port}",
                     LZ4TPU_NUM_PROCESSES="2", LZ4TPU_PROCESS_ID=str(pid),
                     LZ4TPU_TEST_OUT=out, OMP_NUM_THREADS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            logs.append(p.communicate()[0])
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"process {i} failed:\n{logs[i][-3000:]}"

    data = random.Random(77).randbytes(9_000) * 40
    blobs = [open(f"{out}.{r}", "rb").read() for r in range(2)]
    assert blobs[0] == blobs[1] == jframe.compress(
        data, settings=jframe.EncoderSettings(chain_blocks=False, block_size=65536),
        backend="host", workers=0)
    chained = [open(f"{out}.{r}.chained", "rb").read() for r in range(2)]
    assert chained[0] == chained[1] == jframe.compress(
        data, settings=jframe.EncoderSettings(chain_blocks=True, block_size=65536),
        backend="host")
    assert jframe.decompress(chained[0], backend="host") == data


@pytest.mark.parametrize("level", [0, 9])
def test_chained_compress_distributed_single_process(level):
    rng = random.Random(31)
    words = [rng.randbytes(rng.randint(3, 8)) for _ in range(40)]
    data = (b" ".join(rng.choice(words) for _ in range(12000))[:60_000]
            + rng.randbytes(20_000) + bytes(20_000))
    assert len(data) == 100_000  # two blocks
    kw = dict(chain_blocks=True, block_size=65536, compression_level=level,
              content_checksum=True)
    blob = multihost.compress_distributed(data, settings=EncoderSettings(**kw), device="cpu")
    assert blob == jframe.compress(data, settings=jframe.EncoderSettings(**kw), backend="host")
    assert blob == jmh.compress_distributed(data, settings=jframe.EncoderSettings(**kw))


def test_decompress_distributed_single_process():
    data = random.Random(5).randbytes(7000) * 30
    kw = dict(chain_blocks=False, block_size=65536, content_checksum=True,
              block_checksum=True)
    blob = multihost.compress_distributed(data, settings=EncoderSettings(**kw), device="cpu")
    assert blob == jmh.compress_distributed(data, settings=jframe.EncoderSettings(**kw))
    assert multihost.decompress_distributed(blob, device="cpu") == data
    assert multihost.compress_distributed(b"", device="cpu") == jmh.compress_distributed(b"")

    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0x20
    with pytest.raises(JaxLZ4FormatError):
        jmh.decompress_distributed(bytes(bad))
    with pytest.raises(LZ4FormatError):
        multihost.decompress_distributed(bytes(bad), device="cpu")

    chained = jframe.compress(data, settings=jframe.EncoderSettings(
        chain_blocks=True, block_size=65536), backend="host")
    with pytest.raises(LZ4FormatError):
        multihost.decompress_distributed(chained, device="cpu")
