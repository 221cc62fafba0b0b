"""T-LESS v2 dataset fetcher (t_less_toolkit/t-less_download.py rebuilt).

Twin of the JAX package's ``tools/tless_download.py``, on the standard
library only.  Builds the official archive URL list (train and test per
sensor and scene or object id, CAD or reconstructed models) and either
writes it as a manifest (``--manifest``, offline: feed it to any
downloader), prints it, or downloads and unpacks it (``--fetch``, which
needs network access; each archive that fails is reported and skipped).

URL scheme (t-less_download.py:545-671):
  http://ptak.felk.cvut.cz/darwin/t-less/v2/t-less_v2_{train|test}_{sensor}_{id:02d}.zip
  http://ptak.felk.cvut.cz/darwin/t-less/v2/t-less_v2_models_{cad|reconst}.zip

Examples:
  python -m sixdpose_tpu_torch.tools.tless_download --manifest urls.txt --sensors primesense
  python -m sixdpose_tpu_torch.tools.tless_download --fetch --dest data --objects 1 2 --scenes 1
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import zipfile

VERSION = 2
URL_ROOT = f"http://ptak.felk.cvut.cz/darwin/t-less/v{VERSION}"
ROOT = f"t-less_v{VERSION}"
SENSORS = ["primesense", "kinect", "canon"]
MODEL_TYPES = ["cad", "reconst"]
N_OBJECTS = 30
N_SCENES = 20


def build_urls(sensors, obj_ids, scene_ids, model_types):
    """[(url, dest_subdir)] for the requested dataset parts."""
    urls = []
    for sensor in sensors:
        for oid in obj_ids:
            urls.append((f"{URL_ROOT}/{ROOT}_train_{sensor}_{oid:02d}.zip", os.path.join(ROOT, f"train_{sensor}")))
        for sid in scene_ids:
            urls.append((f"{URL_ROOT}/{ROOT}_test_{sensor}_{sid:02d}.zip", os.path.join(ROOT, f"test_{sensor}")))
    for mt in model_types:
        urls.append((f"{URL_ROOT}/{ROOT}_models_{mt}.zip", ROOT))
    return urls


def _retrieve(url, zip_path):
    """Fetch preferring HTTPS (the official host serves plain HTTP; an
    unauthenticated transport invites archive substitution), falling back
    to the original scheme only when the TLS endpoint is unreachable
    (connection refused, no such host, HTTP error).  A failed certificate
    check does not fall back: an attacker breaking TLS must not be able to
    force the downgrade this function exists to prevent."""
    import socket
    import ssl
    import urllib.error
    import urllib.request

    https_url = url.replace("http://", "https://", 1)
    try:
        urllib.request.urlretrieve(https_url, zip_path)
        return https_url
    except (ssl.SSLError, ssl.CertificateError):
        raise
    except urllib.error.URLError as e:
        if isinstance(e.reason, (ssl.SSLError, ssl.CertificateError)):
            raise
        reason = e.reason
    except (socket.error, OSError) as e:
        reason = e
    print(f"WARNING: HTTPS unreachable for {https_url} ({reason}); downgrading to plain HTTP — pass "
          "--checksums to verify archives end-to-end.", file=sys.stderr)
    urllib.request.urlretrieve(url, zip_path)
    return url


def _safe_extract(zf: zipfile.ZipFile, out_dir: str) -> None:
    """extractall with a path-traversal guard (zip-slip)."""
    base = os.path.realpath(out_dir)
    for name in zf.namelist():
        target = os.path.realpath(os.path.join(out_dir, name))
        if not (target == base or target.startswith(base + os.sep)):
            raise RuntimeError(f"archive entry escapes dest: {name!r}")
    zf.extractall(out_dir)


def fetch(urls, dest, checksums=None, retrieve=_retrieve):
    """Download and unpack.  ``checksums``: optional {basename: sha256hex}
    map (from --checksums FILE with 'sha256  name' lines); archives with an
    entry are verified before extraction.  ``retrieve(url, zip_path)``
    downloads one archive.  Returns the number of archives that failed."""
    failures = 0
    for url, sub in urls:
        out_dir = os.path.join(dest, sub)
        os.makedirs(out_dir, exist_ok=True)
        zip_path = os.path.join(dest, os.path.basename(url))
        try:
            print(f"downloaded {retrieve(url, zip_path)}")
            expected = (checksums or {}).get(os.path.basename(url))
            if expected:
                h = hashlib.sha256()
                with open(zip_path, "rb") as f:
                    for chunk in iter(lambda: f.read(1 << 20), b""):
                        h.update(chunk)
                if h.hexdigest() != expected:
                    raise RuntimeError(f"sha256 mismatch: got {h.hexdigest()}, manifest says {expected}")
            print(f"unpacking -> {out_dir}")
            with zipfile.ZipFile(zip_path) as zf:
                _safe_extract(zf, out_dir)
            os.remove(zip_path)
        except Exception as e:  # no network, a partial or tampered archive: report it and go on
            failures += 1
            print(f"FAILED {url}: {e}", file=sys.stderr)
            if os.path.exists(zip_path):
                os.remove(zip_path)
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--sensors", nargs="+", default=SENSORS, choices=SENSORS)
    ap.add_argument("--objects", type=int, nargs="*", default=list(range(1, N_OBJECTS + 1)))
    ap.add_argument("--scenes", type=int, nargs="*", default=list(range(1, N_SCENES + 1)))
    ap.add_argument("--model-types", nargs="+", default=MODEL_TYPES, choices=MODEL_TYPES)
    ap.add_argument("--manifest", default=None, help="write 'url subdir' lines here instead of fetching")
    ap.add_argument("--fetch", action="store_true")
    ap.add_argument("--dest", default=".")
    ap.add_argument("--checksums", default=None,
                    help="file of 'sha256hex  archive-basename' lines; archives listed there are verified before unpack")
    args = ap.parse_args(argv)

    checksums = {}
    if args.checksums:
        with open(args.checksums) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    checksums[parts[1]] = parts[0]

    urls = build_urls(args.sensors, args.objects, args.scenes, args.model_types)
    if args.manifest:
        with open(args.manifest, "w") as f:
            for url, sub in urls:
                f.write(f"{url} {sub}\n")
        print(f"wrote {len(urls)} urls to {args.manifest}")
        return 0
    if args.fetch:
        return 1 if fetch(urls, args.dest, checksums) else 0
    for url, sub in urls:
        print(f"{url} -> {sub}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
