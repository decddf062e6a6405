"""The port's fsspec adapter (seaweedfs_torch/integrations/fsspec_fs.py)
against the reference's: tests/test_aux_surface.py::test_fsspec_adapter
run with each package's adapter over each package's filer, and the
adapter's URL handling (``_strip_protocol``, ``_get_kwargs_from_urls``)
equal on the same URLs. Each case registers its own package's
``seaweedfs://`` implementation first (``register`` replaces the
other's).
"""

import fsspec
import pytest

from cluster_util import Cluster as RCluster
from seaweedfs_torch.integrations import fsspec_fs as pfs
from seaweedfs_torch.server.local_cluster import LocalCluster
from seaweedfs_tpu.integrations import fsspec_fs as rfs

LIBS = {"reference": rfs, "port": pfs}
URLS = ["seaweedfs://127.0.0.1:8888/a/b.txt", "seaweedfs://h:1/",
        "seaweedfs:///x/y", "/plain/path", "seaweedfs://host/no/port",
        "relative/p", "seaweedfs://127.0.0.1:9/", "/"]


@pytest.fixture(scope="module", params=sorted(LIBS))
def filer(request):
    if request.param == "reference":
        cl = RCluster(n_volume_servers=1, pulse=0.15)
        fs = cl.add_filer(chunk_size=8 * 1024)
    else:
        cl = LocalCluster(1, coder_name="torch", device="cpu", pulse=0.15)
        fs = cl.add_filer("memory", 8 * 1024)
    yield request.param, fs
    cl.shutdown()


def test_fsspec_adapter(filer):
    """tests/test_aux_surface.py::test_fsspec_adapter."""
    pkg, fs_server = filer
    LIBS[pkg].register()
    fs = fsspec.filesystem("seaweedfs", filer=fs_server.url)
    assert type(fs) is LIBS[pkg].SeaweedFileSystem

    with fs.open(f"seaweedfs://{fs_server.url}/fsspec/data.txt", "wb") as f:
        f.write(b"fsspec payload")
    assert fs.cat_file("/fsspec/data.txt") == b"fsspec payload"
    assert fs.cat_file("/fsspec/data.txt", start=7, end=14) == b"payload"
    info = fs.info("/fsspec/data.txt")
    assert info["type"] == "file" and info["size"] == 14
    names = fs.ls("/fsspec", detail=False)
    assert "fsspec/data.txt" in names
    assert fs.exists("/fsspec/data.txt")
    fs.mv("/fsspec/data.txt", "/fsspec/moved.txt")
    assert not fs.exists("/fsspec/data.txt")
    with fsspec.open(f"seaweedfs://{fs_server.url}/fsspec/moved.txt") as f:
        assert f.read() == b"fsspec payload"
    fs.rm("/fsspec", recursive=True)
    assert not fs.exists("/fsspec/moved.txt")


def test_pipe_ls_info_and_ranges(filer):
    """pipe_file, a listing of more than one page's worth of names, a
    directory's info, a missing file, and ranges across the filer's
    chunks."""
    pkg, fs_server = filer
    LIBS[pkg].register()
    fs = fsspec.filesystem("seaweedfs", filer=fs_server.url)
    data = bytes(range(256)) * 200  # several 8 KiB chunks
    fs.pipe_file("/rng/big.bin", data)
    for i in range(5):
        fs.pipe_file(f"/rng/s{i}.txt", b"%d" % i)
    fs.mkdir("/rng/sub")
    assert sorted(fs.ls("/rng", detail=False)) == sorted(
        ["rng/big.bin", "rng/sub"] + [f"rng/s{i}.txt" for i in range(5)])
    assert fs.info("/rng/sub")["type"] == "directory"
    assert fs.info("/")["type"] == "directory"
    with pytest.raises(FileNotFoundError):
        fs.info("/rng/none")
    with pytest.raises(FileNotFoundError):
        fs.cat_file("/rng/none")
    for s, e in ((0, 10), (8000, 8500), (16383, 16385), (51000, None)):
        assert fs.cat_file("/rng/big.bin", start=s, end=e) == data[s:e]
    assert fs.ls("/rng/big.bin", detail=False) == ["rng/big.bin"]


@pytest.mark.parametrize("url", URLS)
def test_url_handling_equal(url):
    assert pfs.SeaweedFileSystem._strip_protocol(url) == \
        rfs.SeaweedFileSystem._strip_protocol(url)
    assert pfs.SeaweedFileSystem._get_kwargs_from_urls(url) == \
        rfs.SeaweedFileSystem._get_kwargs_from_urls(url)
