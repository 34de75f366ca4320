"""The kernel sentry in the port against the reference's, exactly.

One synthetic feed of `kernel.<name>.{dispatch,execute,compile}` spans
(each package's own tracer, the same durations and shape meta) goes
through `dds_tpu.obs.sentry` and `dds_tpu_torch.obs.sentry` with the
platform prefix pinned by `DDS_SENTRY_PLATFORM`: `collect`, `compare` on
slower, faster and sub-floor rows, `save_baseline` (merge and overwrite)
and `load_baseline` (missing, malformed) and `persist_from_tracer` give
the same answers. Without the pin the port names `cpu` here (a card's run
names `cuda`: `tests/test_torch_gpu.py`), and its default baseline is a
file of its own, listed in `.gitignore`, never the JAX package's
`benchmarks/kernel_baseline.json`.
"""

import fnmatch
import importlib
import json
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

# (span name, duration ms, shape meta), the kprof spans of a few folds
FEED = [
    ("kernel.foldmany.compile", 812.5, {"R": 4, "P2": 8}),
    ("kernel.foldmany.dispatch", 1.25, {"R": 4, "P2": 8}),
    ("kernel.foldmany.dispatch", 0.75, {"R": 4, "P2": 8}),
    ("kernel.foldmany.execute", 3.0, {"R": 4, "P2": 8}),
    ("kernel.foldmany.execute", 2.5, {"R": 4, "P2": 8}),
    ("kernel.foldmany.execute", 9.0, {"R": 4, "P2": 8}),
    ("kernel.foldmany.execute", 4.0, {"R": 16, "P2": 32}),
    ("kernel.store.reduce.dispatch", 0.5, {"k": 8192, "L": 256, "other": "x"}),
    ("kernel.store.reduce.execute", 0.33, {"k": 8192, "L": 256}),
    ("kernel.predicate.execute", 0.02, {}),
    ("kernel.predicate.warmup", 5.0, {}),
    ("kernel.bare", 1.0, {}),
    ("proxy.fold", 2.0, {"k": 8192}),
]


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def tracer_of(pkg: str, feed=FEED):
    trc = mod(pkg, "utils.trace").Tracer()
    for name, dur, meta in feed:
        trc.record(name, dur, **meta)
    trc.event("kernel.foldmany.execute", R=4, P2=8)  # events are not timings
    return trc


@pytest.fixture
def pinned(monkeypatch):
    monkeypatch.setenv("DDS_SENTRY_PLATFORM", "test")
    monkeypatch.delenv("DDS_KERNEL_BASELINE", raising=False)
    monkeypatch.delenv("DDS_KERNEL_BASELINE_UPDATE", raising=False)


def twin(scenario):
    ref, port = scenario("dds_tpu"), scenario("dds_tpu_torch")
    assert port == ref
    return port


def test_collect_twin(pinned):
    out = twin(lambda pkg: mod(pkg, "obs.sentry").collect(tracer_of(pkg)))
    fm = out["test::foldmany[R=4,P2=8]"]
    assert fm["execute"] == {"p50_ms": 3.0, "p95_ms": 9.0, "count": 3}
    assert fm["compile"]["count"] == 1 and fm["dispatch"]["count"] == 2
    assert set(out) == {"test::foldmany[R=4,P2=8]", "test::foldmany[R=16,P2=32]",
                        "test::store.reduce[k=8192,L=256]", "test::predicate"}


def slower_feed():
    """FEED with foldmany's execute 1.5x slower, store.reduce's by a
    sub-floor 0.03 ms, and foldmany's dispatch faster."""
    out = []
    for name, dur, meta in FEED:
        if name == "kernel.foldmany.execute":
            dur *= 1.5
        elif name == "kernel.store.reduce.execute":
            dur += 0.03
        elif name == "kernel.foldmany.dispatch":
            dur *= 0.5
        out.append((name, dur, meta))
    return out + [("kernel.newcomer.execute", 50.0, {})]


@pytest.mark.parametrize("threshold,floor", [(0.20, 0.05), (0.60, 0.05), (0.0, 0.0)])
def test_compare_twin(pinned, threshold, floor):
    def scenario(pkg):
        s = mod(pkg, "obs.sentry")
        base = s.collect(tracer_of(pkg))
        fresh = s.collect(tracer_of(pkg, slower_feed()))
        return s.compare(base, fresh, threshold=threshold, floor_ms=floor)

    findings = twin(scenario)
    kernels = {(f["kernel"], f["phase"], f["stat"]) for f in findings}
    if threshold == 0.20:
        assert kernels == {("test::foldmany[R=4,P2=8]", "execute", "p50_ms"),
                           ("test::foldmany[R=4,P2=8]", "execute", "p95_ms"),
                           ("test::foldmany[R=16,P2=32]", "execute", "p50_ms"),
                           ("test::foldmany[R=16,P2=32]", "execute", "p95_ms")}
    elif threshold == 0.60:
        assert findings == []
    else:
        assert ("test::store.reduce[k=8192,L=256]", "execute", "p50_ms") in kernels
        assert not any(k[0].startswith("test::newcomer") for k in kernels)


def test_save_load_and_persist_twin(pinned, tmp_path, monkeypatch):
    def scenario(pkg):
        s = mod(pkg, "obs.sentry")
        d = tmp_path / pkg
        path = str(d / "baseline.json")
        out = {"missing": s.load_baseline(path)}
        base = s.collect(tracer_of(pkg))
        out["first"] = s.save_baseline(base, path)
        slower = s.collect(tracer_of(pkg, slower_feed()))
        out["kept"] = s.save_baseline(slower, path)  # existing rows win
        out["overwritten"] = s.save_baseline(slower, path, overwrite=True)
        out["loaded"] = s.load_baseline(path)
        data = json.loads(pathlib.Path(path).read_text())
        out["file"] = (data["version"], sorted(data), data["kernels"])
        bad = d / "bad.json"
        errors = []
        for text in ("{not json", json.dumps({"kernels": []}),
                     json.dumps({"kernels": {"k": {"nope": {}}}}),
                     json.dumps({"kernels": {"k": {"execute": {"p50_ms": "x", "p95_ms": 1}}}})):
            bad.write_text(text)
            with pytest.raises(ValueError) as err:
                s.load_baseline(str(bad))
            errors.append(str(err.value).replace(str(bad), "<path>"))
        out["errors"] = errors
        out["replaced"] = sorted(s.save_baseline(base, str(bad)))  # corrupt -> replaced
        # persist_from_tracer through the env path, then disabled by ""
        env_path = d / "env.json"
        monkeypatch.setenv("DDS_KERNEL_BASELINE", str(env_path))
        trc_mod = mod(pkg, "utils.trace")
        trc_mod.tracer.reset()
        for name, dur, meta in FEED:
            trc_mod.tracer.record(name, dur, **meta)
        out["persisted"] = s.persist_from_tracer()
        out["env_file"] = json.loads(env_path.read_text())["kernels"]
        monkeypatch.setenv("DDS_KERNEL_BASELINE_UPDATE", "1")
        trc_mod.tracer.reset()
        for name, dur, meta in slower_feed():
            trc_mod.tracer.record(name, dur, **meta)
        out["ratcheted"] = s.persist_from_tracer()
        out["env_file_after"] = json.loads(env_path.read_text())["kernels"]
        monkeypatch.setenv("DDS_KERNEL_BASELINE", "")
        out["disabled"] = s.persist_from_tracer()
        trc_mod.tracer.reset()
        monkeypatch.delenv("DDS_KERNEL_BASELINE")
        monkeypatch.delenv("DDS_KERNEL_BASELINE_UPDATE")
        return out

    out = twin(scenario)
    assert out["missing"] == {} and "test::newcomer" in out["kept"]
    assert all(out["kept"][k] == v for k, v in out["first"].items())
    assert out["overwritten"] != out["kept"]
    assert out["disabled"] is None and out["env_file_after"] == out["ratcheted"] | {
        k: v for k, v in out["env_file"].items() if k not in out["ratcheted"]}


def test_platform_and_default_path_are_the_ports_own(monkeypatch):
    """No pin: the port names `cpu` on a host whose process never used a
    card; its default baseline is `dds_tpu_torch/kernel_baseline.json`,
    not the reference's, and `.gitignore` lists it."""
    monkeypatch.delenv("DDS_SENTRY_PLATFORM", raising=False)
    monkeypatch.delenv("DDS_KERNEL_BASELINE", raising=False)
    port, ref = mod("dds_tpu_torch", "obs.sentry"), mod("dds_tpu", "obs.sentry")
    assert port.platform() == "cpu"
    path = port.baseline_path()
    assert path == ROOT / "dds_tpu_torch" / "kernel_baseline.json"
    assert path != ref.baseline_path() == ROOT / "benchmarks" / "kernel_baseline.json"
    rel = path.relative_to(ROOT).as_posix()
    patterns = [ln.strip() for ln in (ROOT / ".gitignore").read_text().splitlines()
                if ln.strip() and not ln.startswith("#")]
    assert any(fnmatch.fnmatch(rel, p) for p in patterns), patterns
    monkeypatch.setenv("DDS_KERNEL_BASELINE", "/elsewhere/b.json")
    assert port.baseline_path() == pathlib.Path("/elsewhere/b.json")
    assert port.baseline_path("given.json") == pathlib.Path("given.json")
    monkeypatch.setenv("DDS_SENTRY_PLATFORM", " cuda ")
    assert port.platform() == ref.platform() == "cuda"
