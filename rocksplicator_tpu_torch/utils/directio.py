"""O_DIRECT file sink for object downloads.
(The port's copy of ``rocksplicator_tpu/utils/directio.py``.)

Reference parity: DirectIOWritableFile (common/s3util.h:82-103) — large SST downloads bypass the page cache so a restore/ingest
storm doesn't evict the serving working set. Semantics reproduced:

- writes buffer into an ALIGNED block (O_DIRECT requires buffer, offset
  and length all aligned); full blocks flush with O_DIRECT pwrites;
- the unaligned tail is written on close through a plain fd (the
  reference's final unaligned chunk takes the same escape hatch);
- filesystems that refuse O_DIRECT (tmpfs, some overlays) degrade to
  buffered IO with a log line rather than failing the download.

Alignment buffer comes from mmap (page-aligned by construction) — no
ctypes posix_memalign needed.
"""

from __future__ import annotations

import logging
import mmap
import os

log = logging.getLogger(__name__)

ALIGN = 4096


class DirectIOFile:
    """Sequential writer; use as a context manager."""

    def __init__(self, path: str, align: int = ALIGN,
                 buffer_blocks: int = 256):
        self._path = path
        self._align = align
        self._cap = align * buffer_blocks
        self._buf = mmap.mmap(-1, self._cap)  # page-aligned anonymous map
        self._fill = 0
        self._offset = 0
        self._direct = True
        try:
            self._fd = os.open(
                path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC | os.O_DIRECT,
                0o644)
        except OSError as e:
            log.info("%s: O_DIRECT unavailable (%s) — buffered fallback",
                     path, e)
            self._direct = False
            self._fd = os.open(
                path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)

    def write(self, data: bytes) -> None:
        view = memoryview(data)
        while len(view):
            take = min(len(view), self._cap - self._fill)
            self._buf[self._fill:self._fill + take] = view[:take]
            self._fill += take
            view = view[take:]
            if self._fill == self._cap:
                self._flush_aligned(self._cap)

    def _flush_aligned(self, nbytes: int) -> None:
        """Write the first ``nbytes`` (aligned) of the buffer, shift the
        remainder down. The memoryview matters: slicing the mmap directly
        would copy to an UNALIGNED heap buffer and O_DIRECT pwrites would
        fail with EINVAL."""
        view = memoryview(self._buf)[:nbytes]
        try:
            done = 0
            while done < nbytes:
                try:
                    n = os.pwrite(self._fd, view[done:],
                                  self._offset + done)
                except OSError as e:
                    if not self._direct:
                        raise
                    # filesystem accepted O_DIRECT at open but rejects
                    # the write (alignment/fs quirks) — degrade to
                    # buffered and retry; a second failure propagates
                    log.info(
                        "%s: O_DIRECT write failed (%s) — buffered "
                        "fallback", self._path, e)
                    os.close(self._fd)
                    self._direct = False
                    self._fd = os.open(self._path, os.O_WRONLY, 0o644)
                    continue
                if n <= 0:
                    # advancing by nbytes anyway would publish a holey
                    # file that os.replace then marks complete
                    raise OSError(
                        f"short pwrite ({n} of {nbytes - done} bytes)")
                done += n
        finally:
            view.release()
        self._offset += nbytes
        rest = self._fill - nbytes
        if rest:
            self._buf[:rest] = self._buf[nbytes:self._fill]
        self._fill = rest

    def close(self) -> None:
        if self._fd < 0:
            return
        full = (self._fill // self._align) * self._align
        if full:
            self._flush_aligned(full)
        tail = bytes(self._buf[:self._fill])
        os.close(self._fd)
        self._fd = -1
        if tail:
            # the final unaligned chunk goes through a buffered fd
            with open(self._path, "r+b") as f:
                f.seek(self._offset)
                f.write(tail)
        self._buf.close()

    def __enter__(self) -> "DirectIOFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
