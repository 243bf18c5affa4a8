"""Incremental (streaming) block encoders and decoders: the bridge between
"one block" and "a stream of blocks".

The port of `lz4_tpu/block/incremental.py` (the reference's `Encoders/`
layer: `LZ4BlockEncoder`, the chain encoders, `LZ4BlockDecoder`,
`LZ4ChainDecoder` and the `LZ4Encoder.Create`/`LZ4Decoder.Create`
factories).  Each block goes through the port's one-block `block.encode`
and `block.decode` on ``device``: kernel B or D on encode, kernel A on
decode, and C's batch form (kernel A with a dictionary row) for a chained
block's 64 KB history.  The carry is the last 64 KB of raw history, kept as
bytes and updated only after a block call returns, so a call that raises
leaves its encoder or decoder as it was.
"""

from __future__ import annotations

from ..constants import DISTANCE_MAX
from . import api as block_api

__all__ = [
    "BlockEncoder",
    "ChainEncoder",
    "BlockDecoder",
    "ChainDecoder",
    "create_encoder",
    "create_decoder",
]

_WINDOW = DISTANCE_MAX + 1  # 64 KB chained-mode history window


class BlockEncoder:
    """Independent-block encoder: no history between blocks."""

    chaining = False

    def __init__(self, level: int = 0, block_size: int = 65536,
                 device="cuda", geometry: str = "canonical"):
        self.level = int(level)
        self.block_size = block_size
        self._device = device
        self._geometry = geometry

    def encode_block(self, raw: bytes) -> bytes:
        return block_api.encode(raw, level=self.level, geometry=self._geometry,
                                device=self._device)


class ChainEncoder:
    """Chained-block encoder carrying a 64 KB dictionary between blocks."""

    chaining = True

    def __init__(self, level: int = 0, block_size: int = 65536, device="cuda"):
        self.level = int(level)
        self.block_size = block_size
        self._device = device
        self._dict = b""

    @property
    def dictionary(self) -> bytes:
        return self._dict

    def encode_block(self, raw: bytes) -> bytes:
        # the dense schedule throughout the chain, the dictionary-less first
        # block included: the bytes of the batched chained encode
        comp = block_api.encode(raw, level=self.level, dictionary=self._dict,
                                geometry="dense", device=self._device)
        self._dict = (self._dict + bytes(raw))[-_WINDOW:]
        return comp

    def reset(self):
        self._dict = b""


class BlockDecoder:
    """Independent-block decoder."""

    chaining = False

    def __init__(self, block_size: int = 65536, device="cuda"):
        self.block_size = block_size
        self._device = device

    def decode_block(self, comp: bytes, expected_length: int | None = None) -> bytes:
        return block_api.decode(comp, target_length=expected_length,
                                capacity=self.block_size, device=self._device)

    def inject_block(self, raw: bytes) -> bytes:
        """Accept a stored (uncompressed) block."""
        return raw


class ChainDecoder:
    """Chained-block decoder with a 64 KB rolling window."""

    chaining = True

    def __init__(self, block_size: int = 65536, dictionary: bytes = b"",
                 device="cuda"):
        self.block_size = block_size
        self._device = device
        self._dict = bytes(dictionary[-_WINDOW:])

    @property
    def dictionary(self) -> bytes:
        return self._dict

    def decode_block(self, comp: bytes, expected_length: int | None = None) -> bytes:
        raw = block_api.decode(comp, target_length=expected_length,
                               dictionary=self._dict, capacity=self.block_size,
                               device=self._device)
        self._dict = (self._dict + raw)[-_WINDOW:]
        return raw

    def inject_block(self, raw: bytes) -> bytes:
        """A stored block still joins the history window."""
        self._dict = (self._dict + bytes(raw))[-_WINDOW:]
        return raw


def check_geometry(chaining: bool, level: int, geometry: str) -> None:
    """Raise ValueError on an unknown geometry, and on a canonical FAST
    chain: it needs upstream's sequential continue schedule, which only the
    one-shot `frame.compress` has."""
    if geometry not in ("auto", "canonical", "dense"):
        raise ValueError(
            f"unknown FAST geometry {geometry!r}; "
            "expected 'auto', 'canonical' or 'dense'"
        )
    if chaining and geometry == "canonical" and int(level) < 3:
        raise ValueError(
            "canonical chained (continue-schedule) FAST frames need "
            "the one-shot frame.compress path; the streaming writer "
            "supports geometry='auto'/'dense' chains (HC/OPT chains "
            "are canonical-identical on every path)"
        )


def create_encoder(chaining: bool, level: int = 0, block_size: int = 65536,
                   device="cuda", geometry: str = "auto"):
    """An encoder for independent or chained blocks.  ``geometry`` "auto"
    takes the canonical schedule for independent blocks and the dense one
    for chains (`check_geometry` says what raises)."""
    check_geometry(chaining, level, geometry)
    if chaining:
        return ChainEncoder(int(level), block_size, device)
    return BlockEncoder(int(level), block_size, device,
                        "dense" if geometry == "dense" else "canonical")


def create_decoder(chaining: bool, block_size: int = 65536,
                   dictionary: bytes = b"", device="cuda"):
    """A decoder for independent or chained blocks."""
    if chaining:
        return ChainDecoder(block_size, dictionary, device)
    return BlockDecoder(block_size, device)
