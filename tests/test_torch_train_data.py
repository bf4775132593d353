"""The port's training data path against the JAX package's, on the CPU:
the random transforms, `train_transforms`, the datasets, the loader and
the synthetic data set.

Every comparison is exact (`np.array_equal`, dtypes too): the port's
random transforms draw the same numbers in the same order from the same
`np.random.Generator`, the loaders key their generators alike, and the
synthetic volumes are written at the configured spacing (1.0 mm), so the
resample of `Spacingd` is the identity grid in both packages (both run the
C++ resampler of `native/miseg_native.cpp`).
"""

import numpy as np
import pytest

from miseg_tpu.config import Config as JConfig
from miseg_tpu.data import dataset as JD
from miseg_tpu.data import multi_modal as JMM
from miseg_tpu.data import transforms as JT
from miseg_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic
from miseg_tpu_torch.config import Config
from miseg_tpu_torch.data import dataset as D
from miseg_tpu_torch.data import multi_modal as MM
from miseg_tpu_torch.data import transforms as T
from miseg_tpu_torch.data.nifti import load_nifti
from miseg_tpu_torch.data.synthetic import make_synthetic_dataset

ROI = (16, 16, 16)


def _equal(got, want, where=""):
    """Exact equality of two transform outputs: dicts (or lists of dicts)
    with the same keys, arrays equal with their dtypes."""
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{where}[{i}]")
        return
    assert set(got) == set(want), where
    for k, w in want.items():
        g = got[k]
        if k == "_rng":
            continue
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), f"{where}.{k}"
        elif isinstance(w, dict):
            _equal(g, w, f"{where}.{k}")
        else:
            assert g == w, f"{where}.{k}"


def _item(rng, shape=(24, 20, 18)):
    """A preprocessed item: channel-last image in [0, 1] and a label map
    with a foreground blob and zero-valued image voxels."""
    img = rng.random((*shape, 1)).astype(np.float32)
    img[:3] = 0.0
    lab = np.zeros((*shape, 1), np.float32)
    lab[5:14, 4:12, 6:15] = rng.integers(1, 4, (9, 8, 9, 1))
    return {"image": img, "label": lab, "modality": 1}


def _pair(name, kw):
    return getattr(T, name)(**kw), getattr(JT, name)(**kw)


CROP = dict(keys=["image", "label"], label_key="label", spatial_size=ROI, pos=1, neg=1,
            num_samples=3, image_key="image", image_threshold=0)
TRANSFORMS = {
    "RandScaleIntensityd": ("RandScaleIntensityd", dict(keys=["image"], factors=0.1, prob=0.5)),
    "RandShiftIntensityd": ("RandShiftIntensityd", dict(keys=["image"], offsets=0.1, prob=0.5)),
    "RandFlipd_0": ("RandFlipd", dict(keys=["image", "label"], prob=0.5, spatial_axis=0)),
    "RandFlipd_2": ("RandFlipd", dict(keys=["image", "label"], prob=0.5, spatial_axis=2)),
    "RandRotate90d": ("RandRotate90d", dict(keys=["image", "label"], prob=0.5, max_k=3)),
    "FgBgToIndicesd": ("FgBgToIndicesd", dict(keys=["label"], image_key="image",
                                              image_threshold=0)),
    "RandCropByPosNegLabeld": ("RandCropByPosNegLabeld", CROP),
    "RandCropByPosNegLabeld_one": ("RandCropByPosNegLabeld", dict(CROP, num_samples=1, pos=2)),
}


@pytest.mark.parametrize("case", sorted(TRANSFORMS))
def test_random_transform_matches_jax(case):
    """Each random transform, over 12 generator seeds (both branches of
    every coin), gives JAX's arrays exactly and leaves the generators in
    the same state."""
    name, kw = TRANSFORMS[case]
    port, jax_t = _pair(name, kw)
    for seed in range(12):
        item = _item(np.random.default_rng(100 + seed))
        rp, rj = np.random.default_rng(seed), np.random.default_rng(seed)
        got = port({**item, "_rng": rp})
        want = jax_t({**item, "_rng": rj})
        _equal(got, want, f"{case} seed {seed}")
        assert rp.random() == rj.random()


def test_crop_from_cached_index_pools_matches_jax():
    """The crop drawing from `FgBgToIndicesd`'s pools (the cached path)
    equals JAX's, and equals the crop that searches the volume itself."""
    item = _item(np.random.default_rng(3))
    with_pools = T.FgBgToIndicesd(keys=["label"], image_key="image")(item)
    for seed in range(6):
        got = T.RandCropByPosNegLabeld(**CROP)({**with_pools, "_rng": np.random.default_rng(seed)})
        want = JT.RandCropByPosNegLabeld(**CROP)({**with_pools,
                                                  "_rng": np.random.default_rng(seed)})
        plain = T.RandCropByPosNegLabeld(**CROP)({**item, "_rng": np.random.default_rng(seed)})
        _equal(got, want)
        _equal(got, plain)
        assert all("label_fg_indices" not in d for d in got)


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """2 train / 1 val / 1 test volumes a modality at 1.0 mm (the configured
    spacing), written by the port's generator."""
    root = tmp_path_factory.mktemp("syn")
    make_synthetic_dataset(root, shape=(22, 20, 18), num_classes=4, n_train=2, n_val=1,
                           n_test=1, spacing=(1.0, 1.0, 1.0), seed=4)
    return root


def _cfg(root, **kw):
    base = dict(roi_x=ROI[0], roi_y=ROI[1], roi_z=ROI[2], data_dirs=[str(root)] * 2,
                json_lists=["CT.json", "MR.json"], batch_size=2, patches_training_sample=2,
                randFlipd_prob=0.5, randRotate90d_prob=0.5, randScaleIntensityd_prob=0.5,
                randShiftIntensityd_prob=0.5, cache_num=8, num_workers=0, seed=11)
    base.update(kw)
    return Config(**base), JConfig(**base)


def test_synthetic_dataset_matches_jax(tmp_path, synthetic):
    jax_make_synthetic(tmp_path, shape=(22, 20, 18), num_classes=4, n_train=2, n_val=1,
                       n_test=1, spacing=(1.0, 1.0, 1.0), seed=4)
    for name in ("CT.json", "MR.json"):
        assert (synthetic / name).read_text() == (tmp_path / name).read_text()
    files = sorted(p.relative_to(synthetic) for p in synthetic.rglob("*.nii.gz"))
    assert len(files) == 16
    for rel in files:
        got, want = load_nifti(synthetic / rel), load_nifti(tmp_path / rel)
        assert got.data.dtype == want.data.dtype and np.array_equal(got.data, want.data)
        assert np.array_equal(got.affine, want.affine)


def test_train_transforms_random_tail_matches_jax(synthetic):
    """`train_transforms` end to end on one volume, over 8 seeds: the same
    list of crops as JAX's (the Spacingd at 1.0 mm is an identity grid)."""
    cfg, jcfg = _cfg(synthetic)
    item = {"image": str(synthetic / "ct_train" / "ct_train_1001_image.nii.gz"),
            "label": str(synthetic / "ct_train" / "ct_train_1001_label.nii.gz"), "modality": 0}
    port, jax_c = MM.train_transforms(cfg), JMM.train_transforms(jcfg)
    for seed in range(8):
        got = port({**item, "_rng": np.random.default_rng(seed)})
        want = jax_c({**item, "_rng": np.random.default_rng(seed)})
        assert isinstance(got, list) and len(got) == 2
        _equal(got, want, f"seed {seed}")
    one = MM.train_transforms(cfg.replace(patches_training_sample=1))(
        {**item, "_rng": np.random.default_rng(0)})
    assert isinstance(one, dict)            # one crop: a dict, as in JAX


@pytest.mark.parametrize("num_workers", [0, 2])
def test_train_loader_matches_jax_for_two_epochs(synthetic, num_workers):
    """The interleaved CT + MR train loader (CacheDataset, shuffle keyed
    (seed, epoch), a generator per item keyed (seed, epoch, index), two
    crops a volume flattened into the batch) yields JAX's batches for 2
    epochs, with or without the prefetch threads."""
    cfg, jcfg = _cfg(synthetic, num_workers=num_workers)
    port = MM.MultiModalData(cfg).train_dataloader()
    jax_l = JMM.MultiModalData(jcfg).train_dataloader()
    assert len(port) == len(jax_l) == 2
    for epoch in range(2):
        port.set_epoch(epoch)
        jax_l.set_epoch(epoch)
        got, want = list(port), list(jax_l)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g["image"].shape == (4, *ROI, 1)
            for k in ("image", "label", "modality"):
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), (epoch, k)
    port.set_epoch(0)
    jax_l.set_epoch(1)
    assert not np.array_equal(next(iter(port))["image"], next(iter(jax_l))["image"])


def test_val_and_test_loaders_match_jax(synthetic):
    cfg, jcfg = _cfg(synthetic, use_normal_dataset=True)
    port, jax_d = MM.MultiModalData(cfg), JMM.MultiModalData(jcfg)
    for split in ("val_dataloader", "test_dataloader"):
        got, want = list(getattr(port, split)()), list(getattr(jax_d, split)())
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            for k in ("image", "label", "modality"):
                assert np.array_equal(g[k], w[k]), (split, k)
    loaders = MM.get_loaders(cfg)
    assert len(loaders) == 2 and len(MM.get_loaders(cfg, test_mode=True)) == 2


@pytest.mark.parametrize("shards", [1, 3])
def test_loader_order_and_sharding_match_jax(shards):
    """Batch indices for several epochs and every shard, drop_last both
    ways, over a dataset of 7 items that records the generator it gets."""

    class Probe:
        def __len__(self):
            return 7

        def get(self, i, rng):
            return {"image": np.array([i, rng.integers(1 << 30)]), "label": np.array(i),
                    "modality": i % 2}

    for shard in range(shards):
        for drop_last in (False, True):
            kw = dict(batch_size=2, shuffle=True, seed=5, drop_last=drop_last, shard=shard,
                      num_shards=shards)
            port, jax_l = D.DataLoader(Probe(), **kw), JD.DataLoader(Probe(), **kw)
            assert len(port) == len(jax_l)
            for epoch in range(3):
                port.set_epoch(epoch)
                jax_l.set_epoch(epoch)
                got, want = list(port), list(jax_l)
                assert len(got) == len(want) == len(port)
                for g, w in zip(got, want):
                    assert all(np.array_equal(g[k], w[k]) for k in ("image", "label",
                                                                     "modality"))


def test_cache_dataset_caches_the_deterministic_prefix():
    """The prefix (up to the first Rand* transform) runs once an item, the
    tail on every access; ConcatDataset maps global indices; collate
    flattens crops like JAX's."""
    calls = []

    class Count(T.Transform):
        def __call__(self, data):
            calls.append(data["id"])
            return dict(data)

    item = _item(np.random.default_rng(1))
    chain = T.Compose([Count(keys=["image"]),
                       T.FgBgToIndicesd(keys=["label"], image_key="image"),
                       T.RandCropByPosNegLabeld(**dict(CROP, num_samples=2)),
                       T.RandFlipd(keys=["image", "label"], prob=0.5, spatial_axis=1)])
    ds = D.CacheDataset([{**item, "id": 0}, {**item, "id": 1}], chain, cache_num=1)
    assert calls == [0]
    a = ds.get(0, np.random.default_rng(2))
    b = ds.get(0, np.random.default_rng(2))
    ds.get(1, np.random.default_rng(2))
    assert calls == [0, 1]                  # item 0 from the cache, item 1 not cached
    _equal(a, b)
    cat = D.ConcatDataset([ds, D.Dataset([{**item, "id": 5}], chain)])
    assert len(cat) == 3 and cat.get(2, np.random.default_rng(0))[0]["id"] == 5
    got = D.default_collate([a, b])
    want = JD.default_collate([a, b])
    assert set(got) == set(want) and got["image"].shape == (4, *ROI, 1)
    assert all(np.array_equal(got[k], want[k]) for k in ("image", "label", "modality"))
    assert got["modality"].dtype == np.int32
