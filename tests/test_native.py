"""The native library is built from its sources, never trusted stale."""

import os
import shutil

from fora import _native


def test_native_library_rebuilds_when_sources_are_newer(tmp_path):
    for name in _native._SOURCES:
        shutil.copy(_native._DIR / name, tmp_path / name)
    so = _native.ensure_built(tmp_path)            # missing: built
    assert so.exists()
    built = so.stat().st_mtime_ns
    assert _native.ensure_built(tmp_path).stat().st_mtime_ns == built

    old = built / 1e9 - 3600                       # library an hour old,
    os.utime(so, (old, old))                       # one source newer
    os.utime(tmp_path / "radix_sort.cpp", (old + 60, old + 60))
    _native.ensure_built(tmp_path)
    assert so.stat().st_mtime > old + 60
