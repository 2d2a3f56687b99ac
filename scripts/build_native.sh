#!/bin/sh
# Build the native host libraries for this host into native/build/:
# libmeshflow_warp (g++ only) and libmeshflow_videoio (needs libav).  The
# package builds them the same way at first use; this is the one-command
# form.  Exits non-zero if a library could not be built.
set -e
cd "$(dirname "$0")/.."
python3 - <<'PY'
import sys

from meshflow.utils import native_build

failed = False
for name in native_build.LIBRARIES:
    if native_build.load(name) is None:
        failed = True
        print(f"{name}: not built: {native_build.error(name)}")
    else:
        print(f"{name}: {native_build.library_path(name)}")
sys.exit(1 if failed else 0)
PY
