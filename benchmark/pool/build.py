"""Build the pool of real bytes that `traffic.py`'s ``pool`` part draws on.

    python3 benchmark/pool/build.py

reads the files below from a Debian 12 image with Python 3.12, numpy,
GDCM, GDAL, PROJ, OpenCV and Perl 5.36 installed (the Python paths from
the interpreter that runs it), and writes
`pool/real.xz` (the streams, one after another, xz-compressed) and
`pool/real.json` (each stream's sources, bytes and SHA-256).  Runs of
the benchmark read only those two files; this script is kept to say
where the bytes came from.  Each stream stands for the Silesia corpus's
files of one kind (Deorowicz, silesia.tar: 211,957,760 bytes), with the
share of the pool that they have of silesia.tar.  The pool is ten whole
4 MiB pieces and a short one, so that silesia.tar's size is five passes
over the whole pieces and then the short one: 50 full 4 MB blocks and a
last block of 2,242,560 bytes, the blocks `lz4 -B7` cuts it into.
"""

import glob
import hashlib
import json
import lzma
import os
import sysconfig
from pathlib import Path

import numpy

HERE = Path(__file__).resolve().parent
PIECE = 4 << 20
POOL_BYTES = 10 * PIECE + 211_957_760 % PIECE
NP = str(Path(numpy.__file__).parent / "_core")
PERL = "/usr/share/perl/5.36.0"
PY = sysconfig.get_paths()["stdlib"]
LIBPYTHON = str(Path(sysconfig.get_config_var("LIBDIR")) / sysconfig.get_config_var("INSTSONAME"))
# the listing names a Python file by its place in the installation
ROOTS = {str(Path(numpy.__file__).parent): "numpy", PY: "python-stdlib",
         sysconfig.get_config_var("LIBDIR"): "python-libdir"}

# (stream, the Silesia files it stands for, their share of silesia.tar in
# per mille, sources in order as (glob, license))
STREAMS = [
    ("executables", "mozilla, ooffice", 271,
     [(LIBPYTHON, "PSF-2.0"),
      (f"{NP}/_multiarray_umath.cpython-312-x86_64-linux-gnu.so", "BSD-3-Clause")]),
    ("documents", "dickens, reymont, webster, xml", 302,
     [("/usr/share/gdcm-3.0/XML/Part3.xml", "BSD-3-Clause"),
      ("/usr/share/gdcm-3.0/XML/Part6.xml", "BSD-3-Clause"),
      (f"{PY}/pydoc_data/topics.py", "PSF-2.0"),
      (f"{PERL}/pod/*.pod", "Artistic-1.0-Perl"),
      (f"{PERL}/**/*.pm", "Artistic-1.0-Perl")]),
    ("text_records", "nci", 158,
     [("/usr/share/gdal/*", "MIT"),
      (f"{PERL}/unicore/**/*.pl", "Unicode-DFS-2016"),
      ("/usr/share/opencv4/haarcascades/*.xml", "Intel-OpenCV (BSD-style)")]),
    ("sources", "samba", 102,
     [(f"{PY}/*.py", "PSF-2.0"), (f"{PY}/*/*.py", "PSF-2.0")]),
    ("binary_records", "osdb, sao", 82,
     [("/usr/share/proj/proj.db", "MIT")]),
    ("raster", "mr, x-ray", 85,
     [("/usr/share/proj/egm96_15.gtx", "public domain (NGA EGM96)")]),
]


def _listed(path: str) -> str:
    for root, name in ROOTS.items():
        if path.startswith(root + "/"):
            return f"{name}/{path[len(root) + 1:]}"
    return path


def main() -> None:
    total_share = sum(s[2] for s in STREAMS)
    streams, blobs, left = [], [], POOL_BYTES
    for i, (name, stands_for, share, sources) in enumerate(STREAMS):
        want = left if i + 1 == len(STREAMS) else POOL_BYTES * share // total_share
        left -= want
        parts, got, used = [], 0, []
        for pattern, licence in sources:
            for path in sorted(glob.glob(pattern, recursive=True)):
                if got >= want or not os.path.isfile(path) or os.path.islink(path):
                    continue
                data = Path(path).read_bytes()[:want - got]
                parts.append(data)
                got += len(data)
                used.append({"path": _listed(path), "bytes": len(data), "license": licence})
        if got != want:
            raise SystemExit(f"{name}: found {got} of {want} bytes")
        blob = b"".join(parts)
        blobs.append(blob)
        streams.append({"name": name, "stands_for": stands_for, "bytes": want,
                        "sha256": hashlib.sha256(blob).hexdigest(), "sources": used})
    pool = b"".join(blobs)
    (HERE / "real.xz").write_bytes(lzma.compress(pool, preset=9 | lzma.PRESET_EXTREME))
    (HERE / "real.json").write_text(json.dumps(
        {"bytes": len(pool), "sha256": hashlib.sha256(pool).hexdigest(), "streams": streams},
        indent=1) + "\n")


if __name__ == "__main__":
    main()
