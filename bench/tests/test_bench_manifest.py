"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files the harness finds by that name; a new cell is added by
adding files and entries only."""

import json
import re
import shutil

import pytest

from benchlib import flops, paths
from benchlib.cell import read_metrics, run_cell
from benchlib.devtrace import TraceData
from benchlib.loop import now
from smoke import smoke_config, smoke_mix

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
MAN = paths.load_json(paths.MANIFEST)
CELLS = {w["name"]: w for w in MAN["workloads"]}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert MAN["paths"] == ["bench"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_names_units_and_lines():
    entries = MAN["configs"] + MAN["workloads"] + MAN["end_to_end"] + MAN["per_layer"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MAN[kind]]
        assert len(names) == len(set(names)), kind
    metric_names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
        assert m["source"] in SOURCES
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["why"]) and _line(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert _line(w["why"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)


def test_cells_name_existing_files():
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert c["file"].startswith("bench/") and (paths.ROOT / c["file"]).exists()
        assert any(w["config"] == c["name"] for w in MAN["workloads"]), c["name"]
    man = paths.Manifest.load()
    for w in MAN["workloads"]:
        cfg, mix = man.config_file(w), man.traffic_file(w)
        assert cfg["num_hidden_layers"] > 0 and mix["loop"] == "closed"
        limits = paths.limits_file(w["name"])
        compared = {k: v for k, v in limits.items() if "limit" in v}
        assert compared, w["name"]
        for name, v in compared.items():        # each limit between its two readings
            assert v["lower"] < v["limit"] < v["upper"] and v["upper"] >= 3 * v["lower"], name
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, len(pairs) // 4)


def test_reduced_names_no_width():
    width = re.compile(r"(hidden|intermediate|latent|state|proj|_dim$|_rank$|head|"
                       r"experts_per_tok|expansion)")
    for c in MAN["configs"]:
        cfg = paths.load_json(paths.ROOT / c["file"])
        assert set(c["reduced"]) == set(cfg["reduced"]), c["name"]
        for k in c["reduced"]:
            assert k == "num_hidden_layers" or not width.search(k), k
            assert k in cfg, k


def test_metrics_bounds_readers_and_moves():
    man = paths.Manifest.load()
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert {m["name"]: m for m in MAN["end_to_end"]}["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert paths.metric_file(m["name"]).exists(), m["name"]
        assert all(w in CELLS for w in m.get("workloads", []))
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        for w in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in man.metrics(w, "end_to_end")}, (m, w)
    for w in CELLS:
        got = {x["name"] for x in man.metrics(w, "end_to_end")}
        assert "setup_s" in got and len(got) >= 2, w
        assert man.metrics(w, "per_layer"), w
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_a_cell_is_added_by_files_and_entries(tmp_path):
    """A copy of the benchmark gains a configuration, a mix, a limit and a
    cell (with its metrics' entries) and runs it, no existing file edited."""
    bench = tmp_path / "bench"
    shutil.copytree(paths.BENCH, bench, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    man = json.loads(json.dumps(MAN))
    (bench / "configs" / "tiny-moe.json").write_text(json.dumps(smoke_config()))
    mix = smoke_mix(paths.Manifest.load(), "mixtral-decode-c4")
    (bench / "traffic" / "tiny-chat.json").write_text(json.dumps(mix))
    (bench / "limits" / "tiny-decode.json").write_text(json.dumps(
        {"gap_mean": {"limit": 1e9}}))
    man["configs"].append({"name": "tiny-moe", "source": "https://example.org/tiny",
                           "file": "bench/configs/tiny-moe.json", "reduced": [], "why": "t"})
    man["workloads"].append({"name": "tiny-decode", "config": "tiny-moe",
                             "traffic": "tiny-chat", "chips": 1, "why": "t"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "mixtral-decode-c4" in m.get("workloads", []):
            m["workloads"].append("tiny-decode")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    after = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())
    res = run_cell(paths.Manifest.load(tmp_path / "BENCHMARK.json"), "tiny-decode", 3, 1.0,
                   False, t_start=__import__("time").perf_counter(), device="cpu", bench=bench)
    assert set(res["metrics"]) == {"decode_tok_s", "setup_s"}
    assert res["correct"] and res["attempted"] > 0


TEST_BLOCK = '''"""A test block: moe_gqa's equations under a reference and a FLOP count of
its own (each FLOP counted twice, so a test tells the two counts apart)."""

from benchlib import flops, spec as specs, weights

REFERENCE = "tiny_reference"
plain_spec = specs.plain_spec
port_config = specs.port_config
make_weights = weights.make_weights


def token_flops(spec, context):
    return 2.0 * flops.token_flops(spec, context)


def chunk_flops(spec, start, n, *, head=False):
    return 2.0 * flops.chunk_flops(spec, start, n, head=head)
'''
MOE_SUBLAYER = ('        x = x + _moe(p["ffn"], _norm(p["ffn_norm"], x, spec), decode, spec, '
                'fp8)\n')


@pytest.mark.parametrize("variant", ["own_reference", "wrong_reference", "dense_kv"])
def test_a_block_is_added_by_files_and_entries(tmp_path, variant):
    """A copy of the benchmark gains a block, its reference, a configuration
    naming the block, a mix, limits and a cell, no existing file edited,
    and the run takes the block's reference (one that leaves out the MoE
    sub-layer fails the check), its FLOP counts and the file's KV layout (dense:
    every admission prefills its whole prompt in one ``join_step``, as the
    configuration file's ``engine.paged_kv: false`` asks)."""
    bench = tmp_path / "bench"
    shutil.copytree(paths.BENCH, bench, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    dense = variant == "dense_kv"
    (bench / "blocks" / "tiny_block.py").write_text(TEST_BLOCK)
    ref_src = (bench / "reference" / "plain.py").read_text()
    assert MOE_SUBLAYER in ref_src
    if variant == "wrong_reference":
        ref_src = ref_src.replace(MOE_SUBLAYER, "")
    (bench / "reference" / "tiny_reference.py").write_text(ref_src)
    cfg = dict(smoke_config(), block="tiny_block")
    cfg["engine"] = dict(cfg["engine"], paged_kv=not dense)
    (bench / "configs" / "tiny-block.json").write_text(json.dumps(cfg))
    mix = smoke_mix(paths.Manifest.load(), "mixtral-decode-c4")
    (bench / "traffic" / "tiny-chat.json").write_text(json.dumps(mix))
    (bench / "limits" / "tiny-block-decode.json").write_bytes(
        (bench / "limits" / "mixtral-decode-c4.json").read_bytes())
    man = json.loads(json.dumps(MAN))
    man["configs"].append({"name": "tiny-block", "source": "https://example.org/tiny",
                           "file": "bench/configs/tiny-block.json", "reduced": [], "why": "t"})
    man["workloads"].append({"name": "tiny-block-decode", "config": "tiny-block",
                             "traffic": "tiny-chat", "chips": 1, "why": "t"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "mixtral-decode-c4" in m.get("workloads", []):
            m["workloads"].append("tiny-block-decode")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    after = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())

    seen = []
    t_start = now()
    res = run_cell(paths.Manifest.load(tmp_path / "BENCHMARK.json"), "tiny-block-decode", 3,
                   1.0, False, t_start=t_start, device="cpu", bench=bench,
                   wrap_backend=lambda b: seen.append(b) or b)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["correct"] == (variant != "wrong_reference"), res["check"]
    rec = res["rec"]
    assert rec.block.__file__ == str(bench / "blocks" / "tiny_block.py")
    assert (seen[0].engine.kv_pool is None) == dense
    entries = [e for _, _, es in rec.joins for e in es]
    whole = [start == 0 and n == rec.prompt_len[rid] for rid, start, n in entries]
    assert all(whole) if dense else not all(whole)
    fed = {}
    for rid, start, n in entries:
        assert start == fed.get(rid, 0)
        fed[rid] = start + n
    assert all(fed[rid] == rec.prompt_len[rid] for rid in fed if rec.stamps[rid])

    rec.trace = TraceData(t_start, now(), [])
    got = {k: v["value"] for k, v in read_metrics(
        rec, [{"name": n, "unit": "%"} for n in ("decode_mfu", "prefill_mfu")]).items()}
    scale = 100.0 / (rec.trace.window_s * 989e12)
    decoded = sum(flops.token_flops(rec.spec, keys) for _, _, es in rec.steps for _, keys in es)
    prefilled = sum(flops.chunk_flops(rec.spec, start, n, head=start + n >= rec.prompt_len[rid])
                    for rid, start, n in entries)
    assert got["decode_mfu"] == pytest.approx(2.0 * decoded * scale)
    assert got["prefill_mfu"] == pytest.approx(2.0 * prefilled * scale)
