"""The port's metric stack (``latte_tpu_torch/eval``: scores, feature
stats, datasets, the seven protocols, ``calc_metric``, the ``calc_metrics``
CLI) and ``tools/convert_videos_to_frames`` against the JAX package's, on
the CPU with the deterministic stand-in detector (numpy, the JAX
package's) over tiny folders of frames, of mp4s and a zip with
``dataset.json`` labels, all written from numpy seeds. The stand-in chain
runs the same numpy arithmetic on the same decoded pixels in both
packages, so results are held to the bit; the world-2 runs over gloo are
held to one process's stats to the bit as well.
"""

import json
import os
import zipfile

import cv2
import numpy as np
import pytest
import torch
from torch_dist_util import eval_stats_run, jobs, one_thread, spawn
from torch_port_util import one_cpu_thread

from latte_tpu.eval import feature_stats as jstats
from latte_tpu.eval import metrics as jmetrics
from latte_tpu.eval import scores as jscores
from latte_tpu.tools import convert_videos_to_frames as jconvert
from latte_tpu_torch.config import load_config
from latte_tpu_torch.eval import calc_metrics, detectors, feature_stats, metrics, scores
from latte_tpu_torch.eval.dataset import MetricVideoDataset
from latte_tpu_torch.sample import sample_many
from latte_tpu_torch.tools import convert_videos_to_frames as convert
from latte_tpu_torch.utils import save_video

FFS = os.path.join(os.path.dirname(__file__), "..", "configs", "ffs", "ffs_sample.yaml")
# a tiny Latte (1 token a frame) and the tiny VAE: 16 frames of 16x16, DDIM-2
TINY_GEN = ["model_overrides={depth: 2, hidden_size: 32, num_heads: 2}", "image_size=16", "num_frames=16",
            "use_fp16=false", "sample_method=ddim", "num_sampling_steps=2", "per_proc_batch_size=2", "vae=tiny"]
PROTOCOLS = ["fvd2048_16f", "fvd2048_128f", "fvd2048_128f_subsample8f", "isv2048_ucf", "fid50k_full",
             "kid50k_full", "is50k"]


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    with one_cpu_thread():
        yield


def clip(seed: int, frames: int = 24, size: int = 32) -> np.ndarray:
    """A moving colour gradient with noise (uint8 (F, H, W, 3)): smooth
    enough that the codec keeps the frames apart."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    t = np.arange(frames, dtype=np.float32)[:, None, None] / frames
    phase, freq = rng.uniform(0, 2 * np.pi, 3), rng.uniform(2, 6, 3)
    v = np.stack([0.5 + 0.5 * np.sin(2 * np.pi * (freq[c] * (xx + yy) / 2 + t) + phase[c]) for c in range(3)], -1)
    return np.clip(v * 255 + rng.normal(0, 4, v.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """real: 11 clips as frame folders (the port's converter); fake: 12
    mp4s; a zip of 3 frame folders with dataset.json labels."""
    root = tmp_path_factory.mktemp("eval")
    real_mp4, fake = root / "real_mp4", root / "fake"
    for i in range(11):
        save_video(str(real_mp4 / f"r{i:02d}.mp4"), clip(i))
    for i in range(12):
        save_video(str(fake / f"f{i:02d}.mp4"), clip(100 + i))
    for v in sorted(os.listdir(real_mp4)):
        convert.convert_one(str(real_mp4 / v), str(real_mp4), str(root / "real"))
    zpath = root / "clips.zip"
    labels = {}
    with zipfile.ZipFile(zpath, "w") as z:
        for c in range(3):
            for f, frame in enumerate(clip(200 + c, frames=20)):
                z.writestr(f"clip{c}/{f:03d}.png", cv2.imencode(".png", frame)[1].tobytes())
                labels[f"clip{c}/{f:03d}.png"] = c * 10
        z.writestr("dataset.json", json.dumps({"labels": list(labels.items())}))
    return dict(root=root, real=str(root / "real"), fake=str(fake), zip=str(zpath))


def test_scores_and_stats_match_jax_to_the_bit(tmp_path):
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal((60, 8)), rng.standard_normal((50, 8)) + 0.3
    mu, cov = x.mean(0), np.cov(x.T)
    mu2, cov2 = y.mean(0), np.cov(y.T)
    assert scores.frechet_distance(mu, cov, mu2, cov2) == jscores.frechet_distance(mu, cov, mu2, cov2)
    assert scores.kernel_distance(x, y, 7, 20, 3) == jscores.kernel_distance(x, y, 7, 20, 3)
    probs = rng.dirichlet(np.ones(10), 40)
    probs[3, 2] = 0.0  # an underflowed probability: x log x -> 0
    for seed in (None, 42):
        assert scores.inception_score(probs, 5, seed) == jscores.inception_score(probs, 5, seed)
    for kw in (dict(capture_all=True, capture_mean_cov=True, max_items=100), dict(capture_mean_cov=True)):
        ours, theirs = feature_stats.FeatureStats(**kw), jstats.FeatureStats(**kw)
        for chunk in np.split(rng.standard_normal((120, 6)).astype(np.float32), 6):
            ours.append_sharded(chunk)
            theirs.append(chunk)
        assert ours.is_full() == theirs.is_full() and ours.num_items == theirs.num_items
        for a, b in zip(ours.get_mean_cov(), theirs.get_mean_cov()):
            np.testing.assert_array_equal(a, b)
        # the same pickle: each package loads the other's file
        ours.save(str(tmp_path / "p.pkl"))
        theirs.save(str(tmp_path / "j.pkl"))
        for a, b in ((jstats.FeatureStats.load(str(tmp_path / "p.pkl")), theirs),
                     (feature_stats.FeatureStats.load(str(tmp_path / "j.pkl")), ours)):
            assert a.__dict__.keys() == b.__dict__.keys()
            np.testing.assert_array_equal(a.raw_cov, b.raw_cov)
    key = (str(tmp_path), "x", 16, 2048, 3, False)
    assert feature_stats.cache_path(*key) == jstats.cache_path(*key)


def _both(name, folders, **opts):
    """``calc_metric`` in both packages with the stand-in detector; the
    records with their reports' last lines."""
    out = []
    for pkg in (metrics, jmetrics):
        report = folders["root"] / f"report_{pkg.__name__.split('.')[0]}"
        rec = pkg.calc_metric(name, report_dir=str(report), detector=detectors.standin_detector(), **opts)
        with open(report / f"metric-{name}.jsonl") as f:
            line = json.loads(f.readlines()[-1])
        assert line == rec
        out.append(rec)
    return out


@pytest.mark.parametrize("name", PROTOCOLS)
def test_protocols_match_jax_to_the_bit(name, folders):
    """Each protocol over the frame folders (real) and the mp4s (fake): the
    port's record equals JAX's but for ``total_time``, every result finite."""
    opts = dict(real_path=folders["real"], fake_path=folders["fake"], max_real=11, max_fake=12,
                num_frames=16, seed=3)
    if name in ("fid50k_full", "kid50k_full", "is50k"):
        opts.update(max_real=100, max_fake=130)
    ours, theirs = _both(name, folders, **opts)
    assert ours["results"] == theirs["results"]
    assert all(np.isfinite(v) for v in ours["results"].values())
    assert {k: v for k, v in ours.items() if k != "total_time"} == {k: v for k, v in theirs.items() if k != "total_time"}


@pytest.mark.parametrize("name", ["fvd2048_16f", "fid50k_full"])
def test_zip_source_matches_jax(name, folders):
    ours, theirs = _both(name, folders, real_path=folders["zip"], fake_path=folders["fake"], max_real=3,
                         max_fake=12, num_frames=16)
    assert ours["results"] == theirs["results"]
    ds = MetricVideoDataset(folders["zip"], num_frames=4)
    assert ds.has_labels and [ds.get_label(i) for i in range(3)] == [0, 10, 20]


def test_cache_replays_and_is_shared_with_jax(folders, tmp_path):
    """A second FVD run reads the real side's stats from ``cache_dir``
    and reproduces the first to the bit; the JAX package's run reads the
    port's cache file (the same key and pickle)."""
    opts = dict(real_path=folders["real"], fake_path=folders["fake"], max_real=11, max_fake=12,
                cache_dir=str(tmp_path), detector=detectors.standin_detector())
    first = metrics.calc_metric("fvd2048_16f", **opts)["results"]
    (cached,) = os.listdir(tmp_path)
    again = metrics.calc_metric("fvd2048_16f", **opts)["results"]
    assert again == first
    assert jmetrics.calc_metric("fvd2048_16f", **opts)["results"] == first
    assert os.listdir(tmp_path) == [cached]


def test_generator_route_matches_jax(folders):
    """``fake_gen`` streams clips (no files): FVD, FID and video IS equal
    JAX's on the same clips; a clip length off the protocol raises."""
    def make_gen(frames=16):
        rng = np.random.default_rng(4)
        return lambda n: (rng.random((4, frames, 32, 32, 3)) * 255).astype(np.uint8)

    for name, extra in (("fvd2048_16f", {}), ("fid50k_full", dict(max_real=60, max_fake=50)),
                        ("isv2048_ucf", dict(max_fake=10))):
        opts = dict(dict(real_path=folders["real"], max_real=8, max_fake=8), **extra)
        got = metrics.calc_metric(name, fake_gen=make_gen(), detector=detectors.standin_detector(), **opts)
        want = jmetrics.calc_metric(name, fake_gen=make_gen(), detector=detectors.standin_detector(), **opts)
        assert got["results"] == want["results"]
    with pytest.raises(ValueError, match="16 frames"):
        metrics.calc_metric("fvd2048_16f", fake_gen=make_gen(8), real_path=folders["real"], max_real=8,
                            detector=detectors.standin_detector())


def test_calc_metrics_cli_on_the_cpu_and_refused_without_a_gpu(folders, capsys):
    """``--device cpu`` scores as ``calc_metric`` does, printing each
    record; without ``--device`` the CLI wants the card and raises here."""
    args = ["--real_data_path", folders["real"], "--fake_data_path", folders["fake"], "--metrics",
            "fvd2048_16f,kid50k_full", "--report_dir", str(folders["root"] / "cli"), "--detector", "standin",
            "--max_real", "11", "--max_fake", "12"]
    records = calc_metrics.main(args + ["--device", "cpu"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["results"] for r in printed] == [r["results"] for r in records]
    want = metrics.calc_metric("fvd2048_16f", real_path=folders["real"], fake_path=folders["fake"], max_real=11,
                               max_fake=12, detector=detectors.standin_detector())
    assert records[0]["results"] == want["results"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            calc_metrics.main(args)


def test_convert_videos_to_frames_matches_jax_byte_for_byte(folders, tmp_path):
    """The port's pool over the fake mp4s (centre crop and resize to 24)
    against the JAX tool's ``convert_one``: the same files, the same bytes."""
    counts = convert.convert(folders["fake"], str(tmp_path / "port"), target_size=24, workers=2)
    for v in convert.find_videos(folders["fake"]):
        jconvert.convert_one(v, folders["fake"], str(tmp_path / "jax"), 24)
    assert counts == [24] * 12
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(files) == 12 * 24
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_sample_many_generator_feeds_fvd(folders):
    """A tiny port ``BatchGenerator`` (tiny Latte and VAE on the CPU) is
    ``fake_gen``: FVD from its clips, 2 calls for 4 items, no file."""
    gen = sample_many.BatchGenerator(load_config(FFS, TINY_GEN), device="cpu")
    before = set(os.listdir(folders["root"]))
    r = metrics.calc_metric("fvd2048_16f", real_path=folders["real"], fake_gen=gen, max_real=11, max_fake=4,
                            detector=detectors.standin_detector())
    assert np.isfinite(r["results"]["fvd2048_16f"]) and gen.it == 2
    assert set(os.listdir(folders["root"])) == before


def test_two_ranks_give_one_process_stats(folders, tmp_path):
    """World 2 over gloo: the generator route (each rank's BatchGenerator
    rows, gathered in shard order) and the file routes (each rank's share
    of batches of 5 clips and 7 frames, 11 clips and 40 frames: unequal
    shares and an empty one) hold the stats of one process, to the bit."""
    kw = dict(gen_items=6, clips=11, video_batch=5, frames=40, frame_batch=7)
    out = str(tmp_path / "ranks")
    with one_thread():
        spawn(jobs, 2, [(eval_stats_run, (FFS, TINY_GEN, folders["real"], folders["fake"], kw, out))])
    ranks = [torch.load(f"{out}.{r}", weights_only=False) for r in range(2)]
    assert ranks[0]["stats"]["generator"]["num_items"] == 6
    det = detectors.standin_detector()
    calls = iter([np.concatenate([r["clips"][i] for r in ranks]) for i in range(len(ranks[0]["clips"]))])
    want = dict(
        generator=metrics.generator_stats(lambda n: next(calls), det, detectors.i3d_features, 6, num_frames=16),
        video=metrics._video_stats(folders["real"], det, detectors.i3d_features, 16, 11, subsample_factor=3,
                                   batch_size=5, capture_all=True),
        frames=metrics._frame_stats(folders["fake"], det, 40, batch_size=7, capture_all=True),
    )
    for name, stats in want.items():
        for r in ranks:
            got = r["stats"][name]
            assert got["num_items"] == stats.num_items, name
            np.testing.assert_array_equal(got["raw_mean"], stats.raw_mean)
            np.testing.assert_array_equal(got["raw_cov"], stats.raw_cov)
            if stats.capture_all:
                np.testing.assert_array_equal(np.concatenate(got["all_features"]), stats.get_all())
