"""Block-level names of the port: the error class, and one-block
`encode`/`decode` on a device with preset dictionaries (the host-only
block APIs come with a later slice)."""


class LZ4Error(ValueError):
    """Malformed LZ4 data."""


from .api import decode, encode  # noqa: E402  (api imports LZ4Error)

__all__ = ["LZ4Error", "encode", "decode"]
