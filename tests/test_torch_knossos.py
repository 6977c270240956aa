"""The port's KNOSSOS datasets (``data/knossos.py``), its KNOSSOS preview
batch (``train_utils.create_preview_batch_from_knossos``), its .k.zip
export (``handlers.write_to_kzip``) and ``_tb_log_sample_images_all_img``
against the JAX package's, on the CPU.

``knossos_utils`` is installed on neither side, so both packages get the
same deterministic stand-in of ``KnossosDataset`` (the one of
``tests/test_knossos.py``: a seeded uint8 volume, two annotation files
of 4096 and 512 voxels). Under the same numpy seed both give the same
patches bit for bit in every mode; the caching mode's loads, the
memory check, the movement-area bounds, the voxel-count weights, the
label offset and order and the merge of two annotations of one area
(contradicting voxels to background) are the same; the preview batch and
the exported .k.zip arguments are equal; the all-images handler writes
one figure an array and channel, under JAX's tags.
"""

import sys

import numpy as np
import pytest

import elektronn3_tpu.data.knossos as jkn
import elektronn3_tpu.training.handlers as jH
import elektronn3_tpu.training.train_utils as jtu
import elektronn3_tpu_torch.data.knossos as pkn
import elektronn3_tpu_torch.training.handlers as pH
import elektronn3_tpu_torch.training.train_utils as ptu
from test_knossos import FakeKD


@pytest.fixture
def fake(monkeypatch):
    monkeypatch.setattr(jkn, "KnossosDataset", FakeKD)
    monkeypatch.setattr(jkn, "_HAS_KNOSSOS", True)
    monkeypatch.setattr(pkn, "KnossosDataset", FakeKD)
    FakeKD.load_calls = 0
    return FakeKD


def _pair(make, seed=0, n=6):
    """``n`` samples of the JAX and the port dataset made by ``make``,
    each under numpy seed ``seed + i``, and each side's load count."""
    out = []
    for mod in (jkn, pkn):
        FakeKD.load_calls = 0
        ds = make(mod)
        samples = []
        for i in range(n):
            np.random.seed(seed + i)
            samples.append(ds[i])
        out.append((ds, samples, FakeKD.load_calls))
    return out


@pytest.mark.parametrize("mode", ["disk", "in_memory", "caching"])
def test_raw_modes_match_jax(fake, mode):
    (jds, js, jcalls), (pds, ps, pcalls) = _pair(
        lambda m: m.KnossosRawData(
            "conf", patch_shape=(4, 6, 8), mode=mode,
            bounds=((0, 0, 0), (16, 16, 16)), cache_size=2, cache_reuses=2,
            epoch_size=5), n=12)
    assert len(pds) == len(jds) == 5
    assert pcalls == jcalls
    for j, p in zip(js, ps):
        assert p["inp"].shape == (1, 4, 6, 8) and p["inp"].dtype == np.float32
        assert np.array_equal(p["inp"], j["inp"])
    want = {"disk": 12, "in_memory": 1, "caching": pcalls}[mode]
    assert pcalls == want
    if mode == "caching":
        assert 2 < pcalls < 12   # filled, then refreshed past its reuses


def test_raw_default_bounds_and_memory_check(fake):
    ds = pkn.KnossosRawData("conf", patch_shape=(4, 4, 4), mode="disk")
    assert np.array_equal(ds.bounds[1], np.array(FakeKD.boundary))
    huge = ((0, 0, 0), (100000, 100000, 100000))
    with pytest.raises(RuntimeError, match="exceeds available memory"):
        pkn.KnossosRawData("conf", patch_shape=(4, 4, 4), mode="in_memory",
                           bounds=huge)
    pkn.KnossosRawData("conf", patch_shape=(4, 4, 4), mode="in_memory",
                       bounds=((0, 0, 0), (8, 8, 8)),
                       disable_memory_check=True)
    with pytest.raises(ValueError, match="mode"):
        pkn.KnossosRawData("conf", patch_shape=(4, 4, 4), mode="ram")


def test_without_knossos_utils_is_an_import_error(monkeypatch):
    monkeypatch.setattr(pkn, "KnossosDataset", None)
    monkeypatch.setitem(sys.modules, "knossos_utils", None)
    with pytest.raises(ImportError, match="knossos_utils"):
        pkn.KnossosRawData("conf", patch_shape=(4, 4, 4))


def test_labels_match_jax(fake, tmp_path):
    (tmp_path / "a.k.zip").touch()
    (tmp_path / "b.k.zip").touch()
    (jds, js, _), (pds, ps, _) = _pair(lambda m: m.KnossosLabels(
        "conf_l", "conf_r", str(tmp_path), patch_shape=(4, 4, 4),
        label_offset=1, label_order=(1, 0), epoch_size=7), n=8)
    assert len(pds) == 7
    for (plo, phi), (jlo, jhi) in zip(pds._bounds, jds._bounds):
        assert np.array_equal(plo, jlo) and np.array_equal(phi, jhi)
    assert np.array_equal(pds._bounds[1][0], (8, 8, 8))
    assert np.allclose(pds._weights, [4096 / 4608, 512 / 4608])
    assert np.array_equal(pds._weights, jds._weights)
    for j, p in zip(js, ps):
        assert np.array_equal(p["inp"], j["inp"])
        assert p["target"].dtype == j["target"].dtype
        assert np.array_equal(p["target"], j["target"])
        assert set(np.unique(p["target"])) <= {0, 1}


def test_labels_merge_and_conflicts_match_jax(fake, tmp_path, monkeypatch):
    (tmp_path / "c.k.zip").touch()
    (tmp_path / "d.k.zip").touch()

    class KD2(FakeKD):
        def get_movement_area(self, kzip_path):
            return (0, 0, 0), (16, 16, 16)

        def from_kzip_to_matrix(self, kzip_path, size, offset, mag=1,
                                verbose=False, show_progress=False):
            m = np.zeros(size, np.int64)
            if "c.k.zip" in kzip_path:
                m[0], m[1] = 1, 2
            else:
                m[1], m[2] = 3, 4
            return m

    monkeypatch.setattr(jkn, "KnossosDataset", KD2)
    monkeypatch.setattr(pkn, "KnossosDataset", KD2)
    made = [m.KnossosLabels("l", "r", str(tmp_path), patch_shape=(4, 4, 4))
            for m in (jkn, pkn)]
    assert [len(d._group_paths) for d in made] == [1, 1]
    (jraw, jlab), (praw, plab) = (
        d._get_data(d._group_paths[0], (0, 0, 0), (4, 4, 4)) for d in made)
    assert np.array_equal(plab, jlab) and np.array_equal(praw, jraw)
    assert np.all(plab[0] == 1) and np.all(plab[1] == 0) \
        and np.all(plab[2] == 4)


def test_labels_require_kzips(fake, tmp_path):
    with pytest.raises(FileNotFoundError):
        pkn.KnossosLabels("c", "c", str(tmp_path), patch_shape=(4, 4, 4))


class PreviewKD(FakeKD):
    def load_raw(self, offset, size, mag=1, datatype=None):
        out = super().load_raw(offset, size, mag)
        return out if datatype is None else out.astype(datatype)


def test_preview_batch_matches_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "knossos_utils",
                        type("M", (), {"KnossosDataset": PreviewKD}))
    monkeypatch.setattr(pkn, "KnossosDataset", None)
    cfg = {"dataset": ["a", "b"], "size": (4, 6, 8), "offset": (1, 2, 3),
           "mag": 1, "target_mags": [1], "scale_brightness": 255.0}
    got = ptu.create_preview_batch_from_knossos(cfg)
    ref = jtu.create_preview_batch_from_knossos(cfg)
    assert got.shape == ref.shape == (1, 2, 4, 6, 8)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    with pytest.raises(ValueError, match="mag"):
        ptu.create_preview_batch_from_knossos({"dataset": "a", "size": 1,
                                               "offset": 0})


def test_write_to_kzip_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "knossos_utils",
                        type("M", (), {"KnossosDataset": FakeKD}))
    monkeypatch.setattr(pkn, "KnossosDataset", None)

    class T:
        knossos_preview_config = {"dataset": ["conf"], "offset": (1, 2, 3),
                                  "size": (8, 6, 4), "target_mags": [1]}
        save_path = str(tmp_path)
        step = 42

    pred = np.random.default_rng(0).integers(0, 3, (1, 4, 6, 8))
    saved = []
    for H in (jH, pH):
        H.write_to_kzip(T(), pred)
        saved.append(dict(FakeKD.saved))
    ref, got = saved
    assert got.keys() == ref.keys()
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            assert np.array_equal(got[k], ref[k]), k
        else:
            assert got[k] == ref[k], k
    assert got["data"].shape == (8, 6, 4)
    assert "preview_42.k.zip" in got["kzip_path"]
    T.knossos_preview_config = None
    with pytest.raises(ValueError, match="knossos_preview_config"):
        pH.write_to_kzip(T(), pred)


class FakeTB:
    def __init__(self):
        self.tags = []

    def add_figure(self, tag, fig, global_step=None):
        import matplotlib.pyplot as plt
        self.tags.append((tag, global_step))
        plt.close(fig)


@pytest.mark.parametrize("shape, figures", [((2, 3, 4, 8, 8), 3 + 4),
                                            ((2, 1, 8, 8), 1 + 1),
                                            ((2, 8, 8), 1 + 1)])
def test_all_img_handler_matches_jax(shape, figures):
    """One figure an array and channel (3D: the middle plane; a 4D
    array is (N, C, H, W), so the 3D case's (N, D, H, W) target gives D
    figures, as in JAX), JAX's tags, ``None`` entries and ``fname`` left
    out."""
    rng = np.random.default_rng(1)
    images = {"inp": rng.normal(size=shape), "skip": None,
              "target": rng.integers(0, 2, shape[:1] + shape[2:])
              if len(shape) > 3 else rng.integers(0, 2, shape),
              "fname": ["vol0"]}
    tags = []
    for H in (jH, pH):
        trainer = type("T", (), {"tb": FakeTB(), "step": 7})()
        H._tb_log_sample_images_all_img(trainer, images, group="g")
        tags.append(trainer.tb.tags)
    assert tags[1] == tags[0]
    assert len(tags[1]) == figures
    trainer = type("T", (), {"tb": None, "step": 0})()
    pH._tb_log_sample_images_all_img(trainer, images)
