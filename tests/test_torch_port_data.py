"""The port's data layer (vptr_tpu_torch.data) against the JAX package's:
the same config, split, seed, epoch and host give equal batches, bit for
bit (transforms, the synthetic generator on its native and Python paths,
the Moving MNIST npz, the KTH and BAIR frame folders, the loader and
build_loader), and the preprocessing helpers give equal results."""

import dataclasses
from contextlib import closing

import numpy as np
import pytest
import torch
from PIL import Image

import vptr_tpu.config as jcfg
import vptr_tpu.data.datasets as jds
import vptr_tpu.data.loader as jld
import vptr_tpu.data.native as jnat
import vptr_tpu.data.preprocessing as jpre
import vptr_tpu.data.transforms as jtf
import vptr_tpu_torch.config as tcfg
import vptr_tpu_torch.data.datasets as tds
import vptr_tpu_torch.data.loader as tld
import vptr_tpu_torch.data.native as tnat
import vptr_tpu_torch.data.preprocessing as tpre
import vptr_tpu_torch.data.transforms as ttf

from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)


def _equal(a, b):
    """Nested tuples / lists of arrays equal, bit for bit."""
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def _clip(seed=0, t=4, h=24, w=20, c=1):
    return np.random.default_rng(seed).random((t, h, w, c)).astype(np.float32)


@pytest.mark.parametrize("name,args", [
    ("center_crop", ((16, 12),)),
    ("resize", ((12, 10),)),
    ("crop", (3, 2, 10, 8)),
    ("pad", (3, 0.25)),
])
def test_transform_functions(name, args):
    for c in (1, 3):
        clip = _clip(t=3, c=c)
        _equal(getattr(ttf, name)(clip, *args), getattr(jtf, name)(clip, *args))


def test_random_flip_same_generator():
    clip = _clip(t=5)
    ra, rb = np.random.default_rng(3), np.random.default_rng(3)
    for p in ((0.5, 0.5), (1.0, 0.0), (0.0, 1.0)):
        for _ in range(8):
            _equal(ttf.random_flip(clip, ra, *p), jtf.random_flip(clip, rb, *p))
    assert ra.random() == rb.random()          # the same draws were taken


def test_normalize_renormalize_and_clip_transform():
    clip = _clip(c=3)
    mean, std = (0.2, 0.4, 0.6), (0.5, 1.5, 2.0)
    _equal(ttf.Normalize(mean, std)(clip), jtf.Normalize(mean, std)(clip))
    _equal(ttf.ReNormalize(mean, std)(clip), jtf.ReNormalize(mean, std)(clip))
    # a tensor renormalises to the numpy values (what evaluate does on the card)
    _equal(ttf.ReNormalize(mean, std)(torch.from_numpy(clip)).numpy(),
           jtf.ReNormalize(mean, std)(clip))
    kw = dict(crop=(20, 16), size=(12, 12), mean=mean, std=std, flips=True)
    got = [ttf.ClipTransform(**kw)(clip, np.random.default_rng(i)) for i in range(4)]
    want = [jtf.ClipTransform(**kw)(clip, np.random.default_rng(i)) for i in range(4)]
    _equal(got, want)


@pytest.mark.parametrize("motion,noise,digits", [
    ("linear", 0.0, 2), ("linear", 0.05, 3), ("dynamic", 0.03, 3),
    ("dynamic", 0.0, 9),                       # > 8 digits: the Python path
])
def test_synthetic_get_and_get_batch(motion, noise, digits):
    kw = dict(num_clips=16, num_past=3, num_future=2, size=48, num_digits=digits,
              seed=5, motion=motion, noise=noise)
    tf_kw = dict(mean=(0.1,), std=(0.9,), flips=True)
    t = tds.SyntheticMovingMNIST(transform=ttf.ClipTransform(**tf_kw), **kw)
    j = jds.SyntheticMovingMNIST(transform=jtf.ClipTransform(**tf_kw), **kw)
    _equal(t.glyphs, j.glyphs)
    for i in (0, 7):                           # the Python path
        _equal(t.get(i, np.random.default_rng(i)), j.get(i, np.random.default_rng(i)))
    idx = np.array([3, 1, 12])                 # the native batch path
    got = t.get_batch(idx, np.random.default_rng(9))
    want = j.get_batch(idx, np.random.default_rng(9))
    assert (got is None) == (want is None) == (not jnat.native_available()
                                                or digits > 8)
    if got is not None:
        _equal(got, want)


def test_native_binding():
    assert tnat.native_available() == jnat.native_available()
    if not tnat.native_available():
        pytest.skip("native library unavailable (both packages take the "
                    "Python path)")
    glyphs = tds.SyntheticMovingMNIST(size=32).glyphs
    idx = np.arange(5)
    for motion in ("linear", "dynamic"):
        _equal(tnat.render_clips(glyphs, 4, idx, 6, 32, 3, 3, motion, 0.02),
               jnat.render_clips(glyphs, 4, idx, 6, 32, 3, 3, motion, 0.02))
    u8 = (np.random.default_rng(0).random((2, 8, 8, 3)) * 255).astype(np.uint8)
    _equal(tnat.normalize_u8(u8, (0.5, 0.4, 0.3), (2.0, 1.0, 0.5)),
           jnat.normalize_u8(u8, (0.5, 0.4, 0.3), (2.0, 1.0, 0.5)))
    f32 = _clip(c=1)
    _equal(tnat.normalize_f32(f32, (0.5,), (2.0,)), jnat.normalize_f32(f32, (0.5,), (2.0,)))


def test_moving_mnist_npz(tmp_path):
    rng = np.random.default_rng(0)
    frames = (rng.random((40, 1, 16, 16)) * 255).astype(np.uint8)
    clips = np.stack([np.stack([np.arange(0, 40, 8), np.full(5, 3)], -1),
                      np.stack([np.arange(3, 40, 8), np.full(5, 4)], -1)])
    path = tmp_path / "mm.npz"
    np.savez(path, clips=clips, input_raw_data=frames)
    kw = dict(mean=(0.3,), std=(2.0,), flips=True)
    t = tds.MovingMNISTNpz(str(path), ttf.ClipTransform(**kw))
    j = jds.MovingMNISTNpz(str(path), jtf.ClipTransform(**kw))
    assert len(t) == len(j) == 5
    for i in range(5):
        _equal(t.get(i, np.random.default_rng(i)), j.get(i, np.random.default_rng(i)))


def _frames(folder, n, size=(24, 24), rgb=False, seed=0):
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        shape = size + ((3,) if rgb else ())
        Image.fromarray((rng.random(shape) * 255).astype(np.uint8)).save(
            folder / f"{i:04d}.png")


def test_kth_and_bair_folders(tmp_path):
    kth = tmp_path / "kth"
    for s, (action, person) in enumerate([("boxing", 1), ("boxing", 5), ("boxing", 17),
                                          ("walking_no_empty", 2),
                                          ("walking_no_empty", 18)]):
        _frames(kth / action / f"person{person:02d}_{action}_d1", 13, seed=s)
    bair = tmp_path / "bair"
    for split, n in (("train", 6), ("test", 2)):
        for e in range(n):
            _frames(bair / split / f"example_{e}", 7, (16, 16), rgb=True, seed=10 + e)

    kw = dict(crop=(20, 20), size=(16, 16), mean=(0.5,), std=(1.0,), flips=True)
    tt, jt = ttf.ClipTransform(**kw), jtf.ClipTransform(**kw)
    for split in ("train", "test"):
        got = tds.kth_dataset(str(kth), tt, split, 2, 2, rng=np.random.default_rng(4))
        want = jds.kth_dataset(str(kth), jt, split, 2, 2, rng=np.random.default_rng(4))
        for g, w in zip(got if split == "train" else [got],
                        want if split == "train" else [want]):
            assert [list(map(str, c)) for c in g.clips] == [list(map(str, c)) for c in w.clips]
            for i in range(len(g)):
                _equal(g.get(i, np.random.default_rng(i)), w.get(i, np.random.default_rng(i)))

    tb, jb = ttf.ClipTransform(mean=(0.5,) * 3, std=(0.5,) * 3), \
        jtf.ClipTransform(mean=(0.5,) * 3, std=(0.5,) * 3)
    for split in ("train", "test"):
        got = tds.bair_dataset(str(bair), tb, split, 1, 2, train_val_ratio=0.5)
        want = jds.bair_dataset(str(bair), jb, split, 1, 2, train_val_ratio=0.5)
        for g, w in zip(got if split == "train" else [got],
                        want if split == "train" else [want]):
            assert len(g) == len(w) > 0
            for i in range(len(g)):
                _equal(g.get(i), w.get(i))
    assert [len(c) for c in tds.chop_clips(kth / "boxing" / "person01_boxing_d1", 4)] \
        == [4, 4, 4]


def _loader_batches(loader, epochs=2):
    out = []
    for _ in range(epochs):
        with closing(iter(loader)) as it:
            out.append(list(it))
    return out


@pytest.mark.parametrize("drop_last,host,prefetch", [
    (True, (0, 1), 2), (False, (0, 1), 0), (True, (0, 2), 2), (False, (1, 2), 2),
])
def test_clip_loader_epochs(drop_last, host, prefetch):
    kw = dict(num_clips=11, num_past=2, num_future=2, size=32, seed=3,
              motion="dynamic", noise=0.02)
    tf_kw = dict(mean=(0.2,), std=(0.7,), flips=True)
    t = tds.SyntheticMovingMNIST(transform=ttf.ClipTransform(**tf_kw), **kw)
    j = jds.SyntheticMovingMNIST(transform=jtf.ClipTransform(**tf_kw), **kw)
    lk = dict(batch_size=3, shuffle=True, drop_last=drop_last, seed=7,
              host_id=host[0], num_hosts=host[1], num_workers=2)
    got = _loader_batches(tld.ClipLoader(t, prefetch=prefetch, **lk))
    want = _loader_batches(jld.ClipLoader(j, prefetch=2, **lk))
    _equal(got, want)
    # prefetch off and on give the same batches
    _equal(_loader_batches(tld.ClipLoader(t, prefetch=0, **lk)), got)
    assert len(got[0]) == len(tld.ClipLoader(t, prefetch=0, **lk))


def test_abandoned_iterator_shuts_its_pool():
    ds = tds.SyntheticMovingMNIST(num_clips=64, num_past=2, num_future=2, size=32)
    loader = tld.ClipLoader(ds, 2, prefetch=4, num_workers=2)
    it = iter(loader)
    next(it)
    it.close()                                  # the trainer's early break
    with pytest.raises(StopIteration):
        next(it)


def _data_cfgs(name, **over):
    d = {**dict(dataset=name, data_dir="", batch_size=2, img_size=32,
                num_past_frames=2, num_future_frames=3, test_past_frames=3,
                test_future_frames=2, num_workers=2), **over}
    return jcfg.DataConfig(**d), tcfg.DataConfig(**d)


@pytest.mark.parametrize("name", ["mnist", "kth", "bair", "synthetic"])
def test_build_loader_synthetic_fallback(name):
    jc, tc = _data_cfgs(name)
    for split in ("train", "val", "test"):
        tl = tld.build_loader(tc, split=split, seed=3)
        jl = jld.build_loader(jc, split=split, seed=3)
        assert tl.dataset.transform.flips == jl.dataset.transform.flips == (
            split == "train" and name != "bair")
        for _ in range(2):                      # two epochs, first two batches
            with closing(iter(tl)) as a, closing(iter(jl)) as b:
                _equal([next(a), next(a)], [next(b), next(b)])


def test_build_loader_reads_real_mnist(tmp_path):
    rng = np.random.default_rng(1)
    frames = (rng.random((24, 1, 32, 32)) * 255).astype(np.uint8)
    clips = np.stack([np.stack([np.arange(0, 24, 6), np.full(4, 2)], -1),
                      np.stack([np.arange(2, 24, 6), np.full(4, 3)], -1)])
    for split in ("train", "valid", "test"):
        np.savez(tmp_path / f"moving-mnist-{split}.npz", clips=clips,
                 input_raw_data=frames)
    jc, tc = _data_cfgs("mnist", data_dir=str(tmp_path))
    for split in ("train", "val", "test"):
        tl = tld.build_loader(tc, split=split, seed=1)
        assert isinstance(tl.dataset, tds.MovingMNISTNpz)
        _equal(_loader_batches(tl), _loader_batches(jld.build_loader(jc, split=split, seed=1)))
    with pytest.raises(ValueError, match="unknown dataset"):
        tld.build_dataset(dataclasses.replace(tc, dataset="nope"), split="train")


def test_mean_std_and_person_runs():
    ds = tds.SyntheticMovingMNIST(num_clips=6, num_past=2, num_future=2, size=32,
                                  channels=3)
    jd = jds.SyntheticMovingMNIST(num_clips=6, num_past=2, num_future=2, size=32,
                                  channels=3)
    for mode in ("RGB", "grey_scale"):
        _equal(tpre.mean_std_compute(ds, mode, max_items=4),
               jpre.mean_std_compute(jd, mode, max_items=4))
    present = [False] * 3 + [True] * 25 + [False] * 2 + [True] * 19 + [False] + [True] * 20
    assert tpre.person_run_filter(present, 20) == jpre.person_run_filter(present, 20)


def test_human_detector_and_subsample(tmp_path):
    src = tmp_path / "frames" / "person01_boxing_d1"
    _frames(src, 12, (8, 8), rgb=True)
    detector = lambda img: img.mean() > 100            # noqa: E731
    got = tpre.human_detector(str(tmp_path / "frames"), str(tmp_path / "t"),
                              detector=detector, min_run=2)
    want = jpre.human_detector(str(tmp_path / "frames"), str(tmp_path / "j"),
                               detector=detector, min_run=2)
    assert got == want
    assert sorted(p.name for p in (tmp_path / "t").rglob("*")) == \
        sorted(p.name for p in (tmp_path / "j").rglob("*"))
    tpre.subsample_frames(str(src), str(tmp_path / "ts"), 3)
    jpre.subsample_frames(str(src), str(tmp_path / "js"), 3)
    assert [p.read_bytes() for p in sorted((tmp_path / "ts").iterdir())] == \
        [p.read_bytes() for p in sorted((tmp_path / "js").iterdir())]


def test_write_mjpeg_avi_bytes_equal(tmp_path):
    clip = _clip(t=5, h=16, w=16, c=1)
    tpre.write_mjpeg_avi(clip, str(tmp_path / "t.avi"), fps=8)
    jpre.write_mjpeg_avi(clip, str(tmp_path / "j.avi"), fps=8)
    assert (tmp_path / "t.avi").read_bytes() == (tmp_path / "j.avi").read_bytes()
    got = tpre.visualize_clip(clip, str(tmp_path / "v.mp4"))
    assert open(got, "rb").read()[:4] == b"RIFF"
