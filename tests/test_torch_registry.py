"""The port's model registry against the JAX package's: every case of
``tests/test_registry.py`` (atomic publish, verify-or-quarantine
resolution, atomic alias moves, pin/alias-aware retention, a publisher
SIGKILLed midway) runs on both packages' ``ModelRegistry``, and the two
share one on-disk format: a registry one package publishes, the other
resolves, aliases and pins, and the same payload gets a byte-equal
``manifest.json``.

Nothing here imports jax; the registries are jax-free in both packages.
"""

import os
import signal
import subprocess
import sys
import time

import pytest

from zoo_tpu.serving import registry as jax_registry
from zoo_tpu.util import manifest as jax_manifest

from zoo_tpu_torch.serving import registry as port_registry
from zoo_tpu_torch.util import manifest as port_manifest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"port": port_registry, "jax": jax_registry}
both = pytest.mark.parametrize("pkg", ["port", "jax"])


def _mk(R, tmp_path, keep=8):
    return R.ModelRegistry(str(tmp_path / "registry"), keep=keep)


def _corrupt_one_file(path):
    for name in os.listdir(path):
        if name != "manifest.json":
            with open(os.path.join(path, name), "ab") as f:
                f.write(b"\x00bitrot")
            return name
    raise AssertionError("no payload file to corrupt")


# ---------------------------------------------------------------- specs

@both
def test_registry_spec_parsing(pkg):
    R = PACKAGES[pkg]
    assert R.is_registry_spec("registry:/r:prod")
    assert not R.is_registry_spec("synthetic:double")
    assert R.parse_registry_spec("registry:/a/b:prod") == ("/a/b", "prod")
    assert R.parse_registry_spec("registry:/a/b:v7") == ("/a/b", "v7")
    assert R.parse_registry_spec("registry:/a/b") == ("/a/b", "prod")
    with pytest.raises(ValueError):
        R.parse_registry_spec("registry:")


# -------------------------------------------------------------- publish

@both
def test_publish_resolve_roundtrip_spec_and_file(pkg, tmp_path):
    reg = _mk(PACKAGES[pkg], tmp_path)
    assert reg.publish(spec="synthetic:double:2") == "v1"
    assert reg.model_spec("v1") == ("v1", "synthetic:double:2")
    src = tmp_path / "model.zoo"
    src.write_bytes(b"weights-bytes")
    v2 = reg.publish(str(src))
    version, inner = reg.model_spec(v2)
    assert version == "v2" and inner.endswith("model.zoo")
    with open(inner, "rb") as f:
        assert f.read() == b"weights-bytes"
    d = tmp_path / "saved"
    d.mkdir()
    (d / "graph.pb").write_bytes(b"g")
    (d / "weights.bin").write_bytes(b"w")
    version, inner = reg.model_spec(reg.publish(str(d)))
    assert version == "v3" and os.path.isdir(inner)
    assert sorted(os.listdir(inner)) == ["graph.pb", "manifest.json",
                                         "weights.bin"]


@both
def test_publish_requires_exactly_one_source(pkg, tmp_path):
    reg = _mk(PACKAGES[pkg], tmp_path)
    with pytest.raises(ValueError):
        reg.publish()
    with pytest.raises(ValueError):
        reg.publish("/nope", spec="synthetic:double")
    with pytest.raises(FileNotFoundError):
        reg.publish(str(tmp_path / "missing.zoo"))


@both
def test_resolve_refs(pkg, tmp_path):
    reg = _mk(PACKAGES[pkg], tmp_path)
    reg.publish(spec="a", alias="prod")
    reg.publish(spec="b")
    assert reg.resolve("v1")[0] == "v1"
    assert reg.resolve(1)[0] == "v1"
    assert reg.resolve("latest")[0] == "v2"
    assert reg.resolve("prod")[0] == "v1"
    with pytest.raises(KeyError):
        reg.resolve("staging")
    with pytest.raises(FileNotFoundError):
        reg.resolve("v99")


# -------------------------------------------- corruption -> quarantine

@both
def test_corrupt_version_quarantined_never_served(pkg, tmp_path):
    R = PACKAGES[pkg]
    reg = _mk(R, tmp_path)
    reg.publish(spec="good", alias="prod")
    v2 = reg.publish(spec="will-rot", alias="canary")
    _corrupt_one_file(reg.resolve(v2)[1])
    reg._verified_ok.discard(2)
    with pytest.raises(R.RegistryCorruptError):
        reg.resolve("canary")
    assert reg.versions() == [1]
    assert any(".corrupt" in n for n in os.listdir(reg.versions_dir))
    assert reg.resolve("prod")[0] == "v1"
    assert reg.publish(spec="fresh") == "v3"


@both
def test_missing_manifest_is_corrupt_not_legacy(pkg, tmp_path):
    R = PACKAGES[pkg]
    reg = _mk(R, tmp_path)
    v1 = reg.publish(spec="x")
    os.unlink(os.path.join(reg.resolve(v1)[1], "manifest.json"))
    reg._verified_ok.discard(1)
    with pytest.raises(R.RegistryCorruptError):
        reg.resolve("v1")


@both
def test_set_alias_refuses_corrupt_target(pkg, tmp_path):
    R = PACKAGES[pkg]
    reg = _mk(R, tmp_path)
    reg.publish(spec="good", alias="prod")
    v2 = reg.publish(spec="rot")
    _corrupt_one_file(reg.resolve(v2)[1])
    reg._verified_ok.discard(2)
    with pytest.raises(R.RegistryCorruptError):
        reg.set_alias("prod", v2)
    assert reg.alias_version("prod") == "v1"


@both
def test_alias_move_is_atomic_pointer(pkg, tmp_path):
    reg = _mk(PACKAGES[pkg], tmp_path)
    reg.publish(spec="a", alias="prod")
    v2 = reg.publish(spec="b")
    reg.set_alias("prod", v2)
    assert reg.alias_version("prod") == "v2"
    assert os.listdir(reg.aliases_dir) == ["prod"]
    reg.drop_alias("prod")
    assert reg.alias_version("prod") is None
    reg.drop_alias("prod")
    for bad in ("v2", "7", "latest"):
        with pytest.raises(ValueError):
            reg.set_alias(bad, 1)


# ------------------------------------------------------------ retention

@both
def test_gc_bounds_versions_but_never_aliased_or_pinned(pkg, tmp_path):
    reg = _mk(PACKAGES[pkg], tmp_path, keep=3)
    reg.publish(spec="s0", alias="prod")
    for i in range(1, 8):
        reg.publish(spec=f"s{i}")
    vs = reg.versions()
    assert len(vs) == 3 and 1 in vs, vs
    assert vs[-1] == 8
    with reg.pin("latest") as pinned:
        assert pinned == "v8"
        for i in range(8, 12):
            reg.publish(spec=f"s{i}")
        assert 8 in reg.versions()
    reg.publish(spec="s12")
    assert 8 not in reg.versions()
    assert 1 in reg.versions()


@both
def test_gc_ages_corrupt_dirs_and_stale_staging(pkg, tmp_path):
    R = PACKAGES[pkg]
    reg = _mk(R, tmp_path, keep=2)
    for i in range(6):
        v = reg.publish(spec=f"s{i}")
        _corrupt_one_file(reg.resolve(v)[1])
        reg._verified_ok.discard(int(v[1:]))
        with pytest.raises(R.RegistryCorruptError):
            reg.resolve(v)
    reg.gc()
    corrupt = [n for n in os.listdir(reg.versions_dir) if ".corrupt" in n]
    assert len(corrupt) <= 2, corrupt
    stale = os.path.join(reg.root, ".tmp-v99-999999999")
    os.makedirs(stale)
    reg.gc()
    assert not os.path.exists(stale)


@pytest.mark.timeout(60)
@both
def test_publish_survives_sigkill_midway(pkg, tmp_path):
    """A publisher SIGKILLed mid-stage leaves only a staging dir, and
    the next registry user GCs it."""
    R = PACKAGES[pkg]
    root = str(tmp_path / "registry")
    code = f"""
import sys, time
sys.path.insert(0, {ROOT!r})
from {R.__name__.rsplit('.', 1)[0]} import registry as R
reg = R.ModelRegistry({root!r})
orig = R.write_manifest
def slow(*a, **k):
    print("STAGED", flush=True)
    time.sleep(30)
    return orig(*a, **k)
R.write_manifest = slow
reg.publish(spec="never-commits")
"""
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "STAGED"
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    reg = R.ModelRegistry(root)
    assert reg.versions() == []
    with pytest.raises(FileNotFoundError):
        reg.resolve("latest")
    assert [n for n in os.listdir(reg.root) if n.startswith(".tmp-")]
    reg.gc()
    assert not [n for n in os.listdir(reg.root) if n.startswith(".tmp-")]


# ------------------------------------------------------ across packages

@pytest.mark.parametrize("writer,reader", [("port", "jax"),
                                           ("jax", "port")])
def test_one_package_publishes_the_other_resolves(writer, reader,
                                                  tmp_path):
    w = _mk(PACKAGES[writer], tmp_path)
    src = tmp_path / "model.zoo"
    src.write_bytes(b"\x00\x01model-bytes")
    w.publish(spec="synthetic:double:2", alias="prod")
    w.publish(str(src), alias="canary", metadata={"note": "x"})
    r = _mk(PACKAGES[reader], tmp_path)
    assert r.versions() == [1, 2]
    assert r.aliases() == {"prod": "v1", "canary": "v2"}
    assert r.model_spec("prod") == ("v1", "synthetic:double:2")
    version, inner = r.model_spec("canary")
    assert version == "v2" and open(inner, "rb").read() == src.read_bytes()
    # the reader publishes on, moves an alias and pins; the writer sees
    # it all, and numbering stays append-only across the two
    assert r.publish(spec="synthetic:double:5") == "v3"
    r.set_alias("prod", "v3")
    with r.pin("prod") as pinned:
        assert pinned == "v3"
        w2 = _mk(PACKAGES[writer], tmp_path)
        assert 3 in w2._pinned()
        assert w2.model_spec("prod") == ("v3", "synthetic:double:5")
    assert _mk(PACKAGES[writer], tmp_path)._pinned() == set()


def test_manifest_json_is_byte_equal_for_the_same_payload(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    src = tmp_path / "saved"
    src.mkdir()
    (src / "weights.bin").write_bytes(os.urandom(4096))
    (src / "sub").mkdir()
    (src / "sub" / "graph.pb").write_bytes(b"graph")
    out = {}
    for pkg, R in PACKAGES.items():
        reg = R.ModelRegistry(str(tmp_path / pkg))
        v = reg.publish(str(src), metadata={"run": 7, "tag": "a"})
        with open(os.path.join(reg.resolve(v)[1], "manifest.json"),
                  "rb") as f:
            out[pkg] = f.read()
    assert out["port"] == out["jax"]
    # and the manifest helpers agree on a directory they did not write
    d = str(tmp_path / "port" / "versions" / "v1")
    assert port_manifest.verify_manifest(d) and \
        jax_manifest.verify_manifest(d)
    assert port_manifest.read_manifest(d) == jax_manifest.read_manifest(d)
