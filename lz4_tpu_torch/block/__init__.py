"""Block-level names of the port.  Only the error class so far: the block
API (`encode`/`decode`/`partial_decode`) comes with a later slice."""


class LZ4Error(ValueError):
    """Malformed LZ4 data."""


__all__ = ["LZ4Error"]
