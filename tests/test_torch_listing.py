"""The port's listing (LocalStorage.walk_dir / list_dir,
ErasureObjects.list_objects_raw, ErasureServerPools.list_objects with its
metacache paging and delimiter roll-up) against minio_tpu's on the same
16 drive directories, on the CPU, with hypothesis over key sets, page
sizes, prefixes and delimiters. Every comparison is exact: names,
xl.meta bytes, pages, NextMarker and common prefixes.

The drives are written directly through the port's LocalStorage (one
xl.meta a key a drive, some keys missing on some drives, some keys
behind a delete marker): listing reads only xl.meta, so no shard data is
needed, and a set of four drives (2+2) lists as a set of sixteen does.
"""

import contextlib
import shutil
import tempfile
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from minio_tpu.object.erasure_objects import ErasureObjects as JaxErasureObjects
from minio_tpu.object.pools import ErasureServerPools as JaxPools
from minio_tpu.object.sets import ErasureSets as JaxErasureSets
from minio_tpu.storage.local import LocalStorage as JaxLocalStorage
from minio_tpu_torch.api.errors import from_object_error
from minio_tpu_torch.object.erasure_objects import ErasureObjects
from minio_tpu_torch.object.metacache import ListingLoop
from minio_tpu_torch.object.metadata import hash_order
from minio_tpu_torch.object.pools import ErasureServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.storage.fileinfo import ErasureInfo, FileInfo
from minio_tpu_torch.storage.local import LocalStorage

BUCKET = "bkt"
MOD_TIME = 1_700_000_000_000_000_000
DRIVES = 4

_segment = st.text(alphabet="ab-c.", min_size=1, max_size=3).filter(
    lambda s: s not in (".", ".."))
keys = st.lists(st.lists(_segment, min_size=1, max_size=3).map("/".join),
                min_size=0, max_size=14, unique=True)


def _write(root: Path, names: list[str], missing: dict, deleted: set):
    """xl.meta of each name on each drive but those in missing[name]; a
    name in `deleted` gets a delete marker over its version."""
    disks = [LocalStorage(str(root / f"d{i}"), endpoint=f"d{i}",
                          device="cpu") for i in range(DRIVES)]
    for d in disks:
        d.make_vol(BUCKET)
    for n, name in enumerate(names):
        dist = hash_order(f"{BUCKET}/{name}", DRIVES)
        for i, disk in enumerate(disks):
            if i in missing.get(name, ()):
                continue
            fi = FileInfo(volume=BUCKET, name=name, mod_time_ns=MOD_TIME + n,
                          size=n * 10, metadata={"etag": f"{n:032x}"},
                          erasure=ErasureInfo(data_blocks=2,
                                              parity_blocks=2,
                                              block_size=1 << 20,
                                              index=dist.index(i + 1) + 1,
                                              distribution=dist))
            fi.add_part(1, n * 10, n * 10)
            disk.write_metadata(BUCKET, name, fi)
            if name in deleted:
                disk.write_metadata(BUCKET, name, FileInfo(
                    volume=BUCKET, name=name, version_id=f"{n:08d}-0000-4000-"
                    "8000-000000000000", deleted=True,
                    mod_time_ns=MOD_TIME + 1000 + n))


def _drives(root: Path):
    port = [LocalStorage(str(root / f"d{i}"), endpoint=f"d{i}",
                         device="cpu") for i in range(DRIVES)]
    jax = [JaxLocalStorage(str(root / f"d{i}"), endpoint=f"d{i}")
           for i in range(DRIVES)]
    return port, jax


@pytest.fixture
def root():
    d = Path(tempfile.mkdtemp(prefix="listing-"))
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _outcome(fn):
    """fn()'s value, or the name of the error it raised."""
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 - compared by class name
        return type(exc).__name__


def _case(data, names):
    missing = {n: set(data.draw(st.lists(st.integers(0, DRIVES - 1),
                                         max_size=1)))
               for n in names}
    deleted = set(data.draw(st.lists(st.sampled_from(names), max_size=3))
                  if names else [])
    return missing, deleted


@settings(max_examples=50, deadline=None)
@given(names=keys, data=st.data())
def test_walk_dir_and_list_dir(names, data):
    with tempfile.TemporaryDirectory(prefix="listing-") as d:
        root = Path(d)
        _write(root, names, *_case(data, names))
        port, jax = _drives(root)
        for base in ("", "a", "a/b", "b-", "c/"):
            for forward in ("", "a", "b/a", "c"):
                for i in (0, 3):
                    assert list(port[i].walk_dir(
                        BUCKET, base_dir=base, forward_to=forward)) == \
                        list(jax[i].walk_dir(BUCKET, base_dir=base,
                                             forward_to=forward))
                    assert list(port[i].walk_dir(
                        BUCKET, base_dir=base, recursive=False)) == \
                        list(jax[i].walk_dir(BUCKET, base_dir=base,
                                             recursive=False))
        for path in ["", *{n.rsplit("/", 1)[0] for n in names if "/" in n}]:
            for count in (-1, 1, 2):
                for i in (0, 3):
                    assert _outcome(lambda: port[i].list_dir(
                        BUCKET, path, count)) == _outcome(
                        lambda: jax[i].list_dir(BUCKET, path, count))


@settings(max_examples=50, deadline=None)
@given(names=keys, data=st.data(),
       prefix=st.sampled_from(["", "a", "a/", "b", "c.", "a/b", "-"]))
def test_list_objects_raw(names, data, prefix):
    with tempfile.TemporaryDirectory(prefix="listing-") as d:
        root = Path(d)
        _write(root, names, *_case(data, names))
        port, jax = _drives(root)
        # A drive that is gone drops out of the merge.
        port[2], jax[2] = None, None
        got = list(ErasureObjects(port, 2, device="cpu").list_objects_raw(
            BUCKET, prefix))
        assert got == list(JaxErasureObjects(jax, 2).list_objects_raw(
            BUCKET, prefix))


class _PageLoop(Exception):
    """A listing call went round its metacache pages without end."""


# Metacache pages one _page_all may take: a listing of these few keys
# takes a handful a call; one that goes round takes them all.
_MAX_CACHE_PAGES = 10_000


@contextlib.contextmanager
def _page_cap(pools):
    """Stop a listing call of `pools` with _PageLoop once the listings
    in this block have taken _MAX_CACHE_PAGES metacache pages."""
    calls = [0]
    cache = pools._metacache
    cache_page = cache.page

    def bounded(*args, **kwargs):
        calls[0] += 1
        if calls[0] > _MAX_CACHE_PAGES:
            raise _PageLoop()
        return cache_page(*args, **kwargs)

    cache.page = bounded
    try:
        yield
    finally:
        del cache.page


def _page_all(pools, prefix, delimiter, max_keys, marker=""):
    """Every page of a listing, each as comparable plain values. A
    listing still truncated after 40 pages ends with "did not end":
    minio_tpu's walk order can make paging go round (ROADMAP Queue 3),
    and the port must go round the same way. The same order can make
    one list_objects call go round its metacache pages (ROADMAP Queue
    3): minio_tpu's call never returns and is stopped here after
    _MAX_CACHE_PAGES, the port's must end by itself with ListingLoop,
    and both end the listing with "did not end in a call"."""
    pages = []
    try:
        with _page_cap(pools):
            for _ in range(40):
                res = pools.list_objects(
                    BUCKET, prefix=prefix, marker=marker,
                    delimiter=delimiter, max_keys=max_keys)
                pages.append((res.is_truncated, res.next_marker,
                              res.prefixes,
                              [(o.name, o.etag, o.size, o.mod_time_ns,
                                o.is_latest) for o in res.objects]))
                if not res.is_truncated:
                    return pages
                marker = res.next_marker
        return pages + ["did not end"]
    except _PageLoop:
        assert not isinstance(pools, ErasureServerPools), \
            "the port's list_objects call went round without end"
        return pages + ["did not end in a call"]
    except ListingLoop:
        return pages + ["did not end in a call"]


def _check_pages(names, missing, deleted, prefix, delimiter, max_keys,
                 marker):
    with tempfile.TemporaryDirectory(prefix="listing-") as d:
        root = Path(d)
        _write(root, names, missing, deleted)
        port_disks, jax_disks = _drives(root)
        port = ErasureServerPools([ErasureSets(port_disks, DRIVES,
                                               default_parity=2,
                                               device="cpu")], device="cpu")
        jax = JaxPools([JaxErasureSets(jax_disks, DRIVES, default_parity=2)])
        try:
            pages = _page_all(port, prefix, delimiter, max_keys, marker)
            assert pages == _page_all(jax, prefix, delimiter, max_keys,
                                      marker)
        finally:
            port.close()
            jax._metacache.close()
    return pages


@settings(max_examples=50, deadline=None)
@given(names=keys, data=st.data(),
       prefix=st.sampled_from(["", "a", "a/", "b-", "c"]),
       delimiter=st.sampled_from(["", "/", "-"]),
       max_keys=st.sampled_from([0, 1, 2, 3, 5, 1000]),
       marker=st.sampled_from(["", "a", "b/", "c-c"]))
def test_list_objects_pages(names, data, prefix, delimiter, max_keys,
                            marker):
    _check_pages(names, *_case(data, names), prefix, delimiter, max_keys,
                 marker)


# No key here has a sibling directory whose name it extends by a byte
# below "/", so the walk is in key order and every listing ends.
FIXED_KEYS = ["a/b", "a/c/d", "a/c/e", "a1", "b", "bc/x", "c", "c/a/b",
              "c/b", "ca", "cc", "d"]


@pytest.mark.parametrize("prefix,delimiter", [("", ""), ("", "/"),
                                              ("a/", "/"), ("c", "b"),
                                              ("c/", "")])
@pytest.mark.parametrize("max_keys", [1, 2, 5])
def test_list_objects_pages_fixed(prefix, delimiter, max_keys):
    """Pages of a fixed key set at several page sizes: keys missing on a
    drive, two behind delete markers."""
    pages = _check_pages(FIXED_KEYS, {"a/b": {1}, "c": {0}, "cc": {3}},
                         {"b", "c/b"}, prefix, delimiter, max_keys, "")
    assert pages[-1][0] is False  # the listing ended
    if not delimiter:
        listed = [o[0] for page in pages for o in page[3]]
        assert listed == [k for k in FIXED_KEYS if k.startswith(prefix)
                          and k not in ("b", "c/b")]
        assert len(pages) == -(-len(listed) // max_keys) or \
            len(listed) % max_keys == 0


# The walk lists "cb/a" before "cb./a" (entries sorted with their
# trailing slash); paging from "cb./a" by name starts again before
# "cb/a", so a call that rolls both up under "/" comes back to where it
# was (ROADMAP Queue 3).
ROUND_KEYS = ["a", "cc", "cb/a", "cb./a"]


def test_list_objects_call_that_goes_round():
    """A ListObjects call that goes round its pages: minio_tpu's never
    returns (stopped here by _page_all's cap), the port's ends with
    ListingLoop, which the S3 layer answers as InternalError. The first
    page is the same in both."""
    pages = _check_pages(ROUND_KEYS, {}, set(), "", "/", 1, "")
    assert pages == [(True, "a", ["cb/"], [("a", f"{0:032x}", 0,
                                            MOD_TIME, True)]),
                     "did not end in a call"]
    with tempfile.TemporaryDirectory(prefix="listing-") as d:
        _write(Path(d), ROUND_KEYS, {}, set())
        port = ErasureServerPools([ErasureSets(_drives(Path(d))[0], DRIVES,
                                               default_parity=2,
                                               device="cpu")], device="cpu")
        try:
            with pytest.raises(ListingLoop):
                port.list_objects(BUCKET, marker="a", delimiter="/",
                                  max_keys=1)
            assert from_object_error(ListingLoop("")).api.code == \
                "InternalError"
        finally:
            port.close()


def test_list_object_versions_call_that_goes_round():
    """ListObjectVersions pages the same walk: from key marker "c/a" the
    call pages from "c/" by name, meets "c/a" again and is back where it
    began. minio_tpu's call never returns (stopped by _page_cap), the
    port's ends with ListingLoop."""
    with tempfile.TemporaryDirectory(prefix="listing-") as d:
        _write(Path(d), ["c/a", "c."], {}, set())
        port_disks, jax_disks = _drives(Path(d))
        port = ErasureServerPools([ErasureSets(port_disks, DRIVES,
                                               default_parity=2,
                                               device="cpu")], device="cpu")
        jax = JaxPools([JaxErasureSets(jax_disks, DRIVES, default_parity=2)])
        try:
            for pools, loop in ((port, ListingLoop), (jax, _PageLoop)):
                with _page_cap(pools):
                    first = pools.list_object_versions(BUCKET, max_keys=1)
                    assert (first.is_truncated, first.next_key_marker,
                            [v.name for v in first.versions]) == (
                        True, "c/a", ["c/a"])
                    with pytest.raises(loop):
                        pools.list_object_versions(BUCKET, key_marker="c/a",
                                                   max_keys=1)
        finally:
            port.close()
            jax._metacache.close()


def test_listing_follows_mutations(root):
    """The metacache is keyed by the bucket's generation: a PUT or a
    DELETE between two pages shows in the next page, in both packages
    (each on its own copy of the drives)."""
    import io

    names = [f"k{i:02d}" for i in range(6)]
    seen = {}
    for pkg in ("port", "jax"):
        _write(root / pkg, names, {}, set())
        port_disks, jax_disks = _drives(root / pkg)
        pools = (ErasureServerPools([ErasureSets(port_disks, DRIVES,
                                                 default_parity=2,
                                                 device="cpu")],
                                    device="cpu") if pkg == "port" else
                 JaxPools([JaxErasureSets(jax_disks, DRIVES,
                                          default_parity=2)]))
        try:
            first = pools.list_objects(BUCKET, max_keys=2)
            pools.delete_object(BUCKET, "k03")
            pools.put_object(BUCKET, "k10", io.BytesIO(b""), 0)
            rest = pools.list_objects(BUCKET, marker=first.next_marker)
        finally:
            pools._metacache.close()
        seen[pkg] = ([o.name for o in first.objects],
                     [o.name for o in rest.objects])
    assert seen["port"] == seen["jax"] == (
        ["k00", "k01"], ["k02", "k04", "k05", "k10"])
