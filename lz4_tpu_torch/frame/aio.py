"""Async frame facades: the port of `lz4_tpu/frame/aio.py`.

asyncio wrappers that run the codec (its launches and its copies to and
from the card) in the default executor, so that event loops stay
responsive.
"""

from __future__ import annotations

import asyncio
import functools
import io

from . import api as _api


async def compress(data, settings=None, device="cuda", **kw) -> bytes:
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(None, functools.partial(
        _api.compress, data, settings=settings, device=device, **kw))


async def decompress(data, settings=None, device="cuda", **kw) -> bytes:
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(None, functools.partial(
        _api.decompress, data, settings=settings, device=device, **kw))


class AsyncFrameWriter:
    """Async streaming compressor over an object with ``async write()``."""

    def __init__(self, sink, settings=None, device="cuda"):
        self._buf = io.BytesIO()
        self._writer = _api.FrameWriter(self._buf, settings, device=device)
        self._sink = sink
        # serialise write and close: a second task's frame bytes appended
        # to _buf between another's getvalue() and truncate() would be lost
        self._lock = asyncio.Lock()

    async def _drain(self):
        data = self._buf.getvalue()
        if data:
            self._buf.seek(0)
            self._buf.truncate()
            await self._sink.write(data)

    async def write(self, data) -> int:
        async with self._lock:
            loop = asyncio.get_running_loop()
            n = await loop.run_in_executor(None, self._writer.write, data)
            await self._drain()
            return n

    async def close(self):
        async with self._lock:
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(None, self._writer.close)
            await self._drain()

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.close()
        return False


class _SyncOverAsyncSource:
    """Blocking ``read(n)`` over an async source: each pull goes to the
    event loop with ``run_coroutine_threadsafe``.  Called only from a
    worker thread, never from the loop's own."""

    def __init__(self, source, loop):
        self._source = source
        self._loop = loop
        self._buf = b""

    def read(self, n: int) -> bytes:
        if self._buf:
            out, self._buf = self._buf[:n], self._buf[n:]
            return out
        fut = asyncio.run_coroutine_threadsafe(self._source.read(n), self._loop)
        chunk = bytes(fut.result() or b"")
        if len(chunk) > n:  # a source that returns more: keep the rest
            self._buf = chunk[n:]
            chunk = chunk[:n]
        return chunk


class AsyncFrameReader:
    """Async streaming decompressor over an object with ``async read(n)``:
    compressed bytes are pulled from the source a request at a time as
    output is consumed."""

    def __init__(self, source, dictionary: bytes = b"", device="cuda"):
        self._source = source
        self._device = device
        self._dictionary = dictionary
        self._reader = None

    def _ensure(self, loop):
        if self._reader is None:
            self._reader = _api.FrameReader(
                _SyncOverAsyncSource(self._source, loop),
                dictionary=self._dictionary, device=self._device)

    async def read(self, n: int = -1) -> bytes:
        loop = asyncio.get_running_loop()
        self._ensure(loop)
        return await loop.run_in_executor(None, self._reader.read, n)

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        return False
