"""Element-tile autotuner: candidates, empirical pick, disk memoization."""

import json

from gpu_bench.core import autotune as at


def test_epb_candidates():
    assert at.epb_candidates(1024) == [128, 256, 512, 1024]
    assert at.epb_candidates(384) == [128]  # 256 does not divide 384
    assert at.epb_candidates(64) == [64]  # fallback: e_pad itself


def test_autotune_picks_and_caches(tmp_path, monkeypatch, cfg32):
    monkeypatch.setenv("GPU_BENCH_AUTOTUNE_CACHE",
                       str(tmp_path / "cache.json"))
    monkeypatch.setattr(at, "_CACHE", None)

    from gpu_bench.benchmarks import benchmark04 as b04

    data = b04.prepare(4, 4, 256, cfg32)
    built = []

    def build(te):
        _, fn, args = b04.build_variants(data.replace(te=te), cfg32)[-1]
        built.append(te)
        return fn, args

    epb = at.autotune_epb("test/kron", "nq4", build, cfg32, 256)
    assert epb in (128, 256)
    assert sorted(set(built)) == [128, 256]

    # second call: served from cache, no rebuilds
    built.clear()
    epb2 = at.autotune_epb("test/kron", "nq4", build, cfg32, 256)
    assert epb2 == epb and built == []

    # persisted to disk
    monkeypatch.setattr(at, "_CACHE", None)
    disk = json.load(open(tmp_path / "cache.json"))
    assert any(k.endswith("float32") and "test/kron" in k for k in disk)

    # cached epb that no longer divides e_pad is re-tuned
    built.clear()
    epb3 = at.autotune_epb("test/kron", "nq4", build, cfg32, 128,
                           candidates=[128])
    assert epb3 == 128


def test_autotune_cli_flag(cfg32):
    from gpu_bench.benchmarks import cli
    from gpu_bench.core.config import Config

    args = cli.build_parser("b04", positionals=[("nq0", 8), ("nq1", 8)]
                            ).parse_args(["--autotune"])
    assert Config.from_flags(args).autotune
    args = cli.build_parser("b04").parse_args([])
    assert not Config.from_flags(args).autotune


def test_step_flag():
    from gpu_bench.benchmarks import cli

    args = cli.build_parser("b01").parse_args(["--step", "8",
                                               "--min-size", "1024",
                                               "--max-size", "65536"])
    assert list(cli.sweep(128, 1 << 20, args)) == [1024, 8192, 65536]
    args = cli.build_parser("b01").parse_args([])
    assert list(cli.sweep(128, 1024, args)) == [128, 256, 512, 1024]
