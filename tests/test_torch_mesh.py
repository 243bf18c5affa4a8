"""`mesh=` in the port against the JAX package's 8-virtual-device CPU mesh
(tests/conftest.py): a mesh of 8 `cpu` devices runs X1 and X2 on each
shard, and `parallel.encode_blocks`, `decode_blocks` and
`frame.compress/decompress` with ``mesh=`` equal the JAX package's results
byte for byte (the cases of tests/test_parallel.py, with one-block and
chained payloads); a mesh of CUDA devices without a card raises."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lz4_tpu import frame as jframe
from lz4_tpu.block.hostref import LZ4Error as JaxLZ4Error
from lz4_tpu.parallel import blocks as JB
from lz4_tpu_torch import frame as tframe
from lz4_tpu_torch import parallel
from lz4_tpu_torch.block import LZ4Error
from lz4_tpu_torch.ops import decode_dense, encode_dense
from lz4_tpu_torch.parallel import blocks as TB


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The dense codecs are many small tensor ops: each runs on one thread,
    so that the test workers sharing the machine's cores do not stall on
    one another's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return JB.make_mesh(jax.devices()[:8]), parallel.make_mesh(["cpu"] * 8)


@pytest.mark.parametrize("level", [0, 3])
def test_encode_blocks_sharded_equals_jax(meshes, lorem, rng, level):
    jmesh, tmesh = meshes
    data = lorem(200_000 if level == 0 else 40_000, rng)
    ours = parallel.encode_blocks(data, block_size=16384, level=level, mesh=tmesh)
    assert ours == JB.encode_blocks(data, block_size=16384, level=level, mesh=jmesh)
    assert parallel.decode_blocks(ours, 16384, total_length=len(data), mesh=tmesh) == data


def test_roundtrip_sharded(meshes, lorem, rng):
    data = lorem(150_000, rng)
    comp = parallel.encode_blocks(data, block_size=16384, mesh=meshes[1])
    out = parallel.decode_blocks(comp, 16384, total_length=len(data), mesh=meshes[1])
    assert out == data


def test_roundtrip_unsharded(lorem, rng):
    data = lorem(60_000, rng)
    comp = parallel.encode_blocks(data, block_size=8192, device="cpu")
    assert parallel.decode_blocks(comp, 8192, total_length=len(data), device="cpu") == data


def test_uneven_tail_block(meshes, rng):
    data = bytes(rng.choice(b"xyz") for _ in range(10_000))
    comp = parallel.encode_blocks(data, block_size=4096, mesh=meshes[1])
    assert comp == JB.encode_blocks(data, block_size=4096, mesh=meshes[0])
    assert parallel.decode_blocks(comp, 4096, mesh=meshes[1]) == data


def test_batch_padding_not_multiple_of_devices(meshes, lorem, rng):
    # 3 real blocks over 8 devices: the padding rows must not reach the output
    data = lorem(40_000, rng)
    comp = parallel.encode_blocks(data, block_size=16384, mesh=meshes[1])
    assert len(comp) == 3
    assert comp == JB.encode_blocks(data, block_size=16384, mesh=meshes[0])
    assert parallel.decode_blocks(comp, 16384, mesh=meshes[1]) == data


def test_decode_error_surfaces(meshes):
    # one literal, then a match at offset 0 (invalid)
    bad = [b"\x10a\x00\x00\x00"]
    with pytest.raises(JaxLZ4Error) as theirs:
        JB.decode_blocks(bad, 4096, mesh=meshes[0])
    with pytest.raises(LZ4Error) as ours:
        parallel.decode_blocks(bad, 4096, mesh=meshes[1])
    assert str(ours.value) == str(theirs.value)


def test_sharded_fns_equal_the_jax_mesh(meshes):
    rng = np.random.default_rng(3)
    words = rng.integers(0, 4, (8, 4096)).astype(np.uint8) * 17
    bufs = np.zeros((8, 4096 + 1024), np.uint8)
    bufs[:, :4096] = words
    lens = np.asarray([4096, 4000, 1, 0, 13, 4096, 700, 2048], np.int32)
    theirs = JB.sharded_encode_fn(meshes[0], 4096, 2)(jnp.asarray(bufs), jnp.asarray(lens))
    ours = parallel.sharded_encode_fn(meshes[1], 4096, 2)(bufs, lens)
    for t, o in zip(theirs, ours):
        assert np.array_equal(np.asarray(t), o.numpy())
    comps = np.zeros((8, TB.comp_capacity(4096)), np.uint8)
    for i in range(8):
        comps[i, :int(ours[1][i])] = ours[0][i, :int(ours[1][i])].numpy()
    theirs = JB.sharded_decode_fn(meshes[0], 4096)(jnp.asarray(comps), ours[1].numpy())
    ours = parallel.sharded_decode_fn(meshes[1], 4096)(comps, ours[1])
    for t, o in zip(theirs, ours):
        assert np.array_equal(np.asarray(t), o.numpy())
    with pytest.raises(ValueError, match="split evenly"):
        parallel.sharded_decode_fn(meshes[1], 4096)(comps[:5], ours[1][:5])


def test_shards_launch_once_per_device(meshes, lorem, rng):
    data = lorem(40_000, rng)
    encode_dense.encode_block_fixed.launches = 0
    decode_dense.decode_block_fixed.launches = 0
    comp = parallel.encode_blocks(data, block_size=16384, mesh=meshes[1])
    parallel.decode_blocks(comp, 16384, mesh=meshes[1])
    assert encode_dense.encode_block_fixed.launches == 8
    assert decode_dense.decode_block_fixed.launches == 8


INDEPENDENT = dict(chain_blocks=False, block_size=65536)


@pytest.mark.parametrize("settings", [
    INDEPENDENT,
    dict(INDEPENDENT, block_checksum=True, content_checksum=True),
    dict(chain_blocks=False, block_size=262144, content_checksum=True),
], ids=["independent", "checksums", "256KB"])
def test_frame_with_a_mesh_equals_jax(meshes, lorem, rng, settings):
    jmesh, tmesh = meshes
    data = lorem(300_000, rng)
    ours = tframe.compress(data, tframe.EncoderSettings(**settings), mesh=tmesh)
    assert ours == jframe.compress(data, jframe.EncoderSettings(**settings), mesh=jmesh)
    assert tframe.decompress(ours, mesh=tmesh) == data
    assert jframe.decompress(ours, mesh=jmesh) == data


@pytest.mark.parametrize("settings", [
    INDEPENDENT,  # one block: the route without a mesh, canonical bytes
    dict(),  # chained: the chained route on the mesh's first device
], ids=["one_block", "chained"])
def test_frame_routes_a_mesh_passes_by(meshes, lorem, rng, settings):
    jmesh, tmesh = meshes
    data = lorem(50_000 if settings == INDEPENDENT else 200_000, rng)
    ours = tframe.compress(data, tframe.EncoderSettings(**settings), mesh=tmesh)
    assert ours == jframe.compress(data, jframe.EncoderSettings(**settings), mesh=jmesh)
    assert ours == tframe.compress(data, tframe.EncoderSettings(**settings), device="cpu")
    assert tframe.decompress(ours, mesh=tmesh) == data


def test_frame_decompress_with_a_mesh_takes_x2_only_for_compressed_blocks(meshes, rng):
    jmesh, tmesh = meshes
    # a stored block (noise) between compressed ones: the route without a mesh
    data = b"a" * 65536 + rng.randbytes(65536) + b"b" * 65536
    blob = jframe.compress(data, jframe.EncoderSettings(**INDEPENDENT), backend="host")
    decode_dense.decode_block_fixed.launches = 0
    assert tframe.decompress(blob, mesh=tmesh) == data
    assert decode_dense.decode_block_fixed.launches == 0
    one = jframe.compress(b"c" * 1000, jframe.EncoderSettings(**INDEPENDENT), backend="host")
    assert tframe.decompress(one, mesh=tmesh) == b"c" * 1000
    assert decode_dense.decode_block_fixed.launches == 8
    # a malformed block (a match at offset 0 after the 7-byte header and
    # the first block's length) raises as the JAX mesh route does
    bad = bytearray(jframe.compress(b"xyz" * 50000, jframe.EncoderSettings(**INDEPENDENT),
                                    backend="host"))
    bad[11:16] = b"\x10a\x00\x00\x00"
    with pytest.raises(ValueError) as theirs:
        jframe.decompress(bytes(bad), mesh=jmesh)
    with pytest.raises(ValueError) as ours:
        tframe.decompress(bytes(bad), mesh=tmesh)
    assert type(ours.value).__name__ == type(theirs.value).__name__


def test_canonical_chained_fast_with_a_mesh_raises(meshes, lorem, rng):
    data = lorem(200_000, rng)
    with pytest.raises(ValueError, match="canonical chained"):
        jframe.compress(data, jframe.EncoderSettings(geometry="canonical"), mesh=meshes[0])
    with pytest.raises(ValueError, match="canonical chained"):
        tframe.compress(data, tframe.EncoderSettings(geometry="canonical"), mesh=meshes[1])


def test_make_mesh_needs_the_card_for_cuda(monkeypatch):
    mesh = parallel.make_mesh(["cpu", "cpu"], axis="rows")
    assert mesh.size == 2 and mesh.axis == "rows"
    assert all(d == torch.device("cpu") for d in mesh.devices)
    with pytest.raises(ValueError, match="axis"):
        parallel.sharded_encode_fn(mesh, 4096, 1)(np.zeros((2, 5120), np.uint8),
                                                  np.zeros(2, np.int32))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parallel.make_mesh(["cuda:0", "cuda:0"])


def test_warmup_device_on_the_cpu_warms_nothing():
    assert parallel.warmup_device(65536, levels=(0, 9), device="cpu") == 0


def test_the_jax_package_s_nine_names():
    import lz4_tpu.parallel as jp

    names = [n for n in dir(jp) if not n.startswith("_") and n != "blocks"]
    for name in names:
        if name in ("multihost",):
            continue
        assert hasattr(parallel, name), name
