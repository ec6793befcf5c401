"""The port's training data path (conf/datasets, preprocessing/datasets, preprocessing/materialize,
preprocessing/download, VideoTransform.host_geometry) against merv_tpu's.

A tiny dataset is written to ``tmp_path`` (GIF videos, PNG images, text-only
conversations, as tests/test_training_pipeline.py writes it) and read by both
packages' datasets with the same transforms and the ByteTokenizer of the tiny
LLM: token ids, labels (human turns masked), uint8 frames, modality lengths,
collated batches and sampler orders must be equal, exactly (the same integer
and uint8 operations on both sides; frames through each package's decoder and
cv2). The downloader's archive guard is tested on local archives, as
tests/test_download.py does.
"""

import json
import shutil
import tarfile
import zipfile
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import merv_tpu.conf.datasets as jax_conf
import merv_tpu.conf.registry as jax_draccus
import merv_tpu.preprocessing.download as jax_download
import merv_tpu.preprocessing.materialize as jax_mat
import merv_tpu.preprocessing.transforms as jax_tf
from merv_tpu.models.backbones.llm.base_llm import tiny_llm_backbone as jax_tiny_llm
from merv_tpu.preprocessing.datasets import AlignVideoDataset as JaxAlign
from merv_tpu.preprocessing.datasets import FinetuneVideoDataset as JaxFinetune
from merv_tpu.util.batching_utils import SplitModalitySampler as JaxSplitModalitySampler
import merv_tpu_torch.conf.registry as draccus
import merv_tpu_torch.preprocessing.download as download
import merv_tpu_torch.preprocessing.materialize as mat
import merv_tpu_torch.preprocessing.transforms as tf
from merv_tpu_torch.conf import DatasetConfig, DatasetRegistry
from merv_tpu_torch.models.backbones.llm.base_llm import tiny_llm_backbone
from merv_tpu_torch.models.vidlms import IGNORE_INDEX
from merv_tpu_torch.preprocessing.datasets import AlignVideoDataset, FinetuneVideoDataset
from merv_tpu_torch.util.batching_utils import SplitModalitySampler

# one transform of each kind the towers use: resize-naive bicubic (DINOv2, SigLIP, ViViT), resize-crop bilinear
# with [C, T, S, S] output (LanguageBind), letterbox
TRANSFORMS = (
    dict(target_size=32, resize_strategy="resize-naive", interpolation="bicubic"),
    dict(target_size=24, resize_strategy="resize-crop", shortest_edge=24, interpolation="bilinear",
         channels_first_time=True),
    dict(target_size=16, resize_strategy="letterbox", interpolation="bicubic", mean=tf.SIGLIP_MEAN, std=tf.SIGLIP_STD),
)
NUM_FRAMES = [4, 2, 4]


def _write_dataset(root: Path, n_video=4, n_image=2, n_text=2, turns=2):
    """GIF videos (6 frames of 48 x 64), PNG images (40 x 56) and text-only
    conversations; ``turns`` human / gpt pairs each."""
    media = root / "media"
    media.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(0)
    examples = []

    def conversation(first, i):
        conv = []
        for t in range(turns):
            conv.append({"from": "human", "value": (first + "\n" if t == 0 else "") + f"Question {t} about item {i}?"})
            conv.append({"from": "gpt", "value": f"Answer {t} for item {i}: noise of kind {rng.randint(100)}."})
        return conv

    for i in range(n_video):
        frames = [Image.fromarray(rng.randint(0, 255, (48, 64, 3), dtype=np.uint8)) for _ in range(6)]
        frames[0].save(media / f"vid{i}.gif", save_all=True, append_images=frames[1:])
        examples.append({"video": f"vid{i}.gif", "conversations": conversation("<video>", i)})
    for i in range(n_image):
        Image.fromarray(rng.randint(0, 255, (40, 56, 3), dtype=np.uint8)).save(media / f"img{i}.png")
        examples.append({"image": f"img{i}.png", "conversations": conversation("<image>", i)})
    for i in range(n_text):
        examples.append({"conversations": conversation("", i)})
    align = [dict(ex, conversations=ex["conversations"][:2]) for ex in examples]
    (root / "align.json").write_text(json.dumps(align))
    (root / "chat.json").write_text(json.dumps(examples))
    return root / "align.json", root / "chat.json", media


def _transforms():
    return [tf.VideoTransform(**kw) for kw in TRANSFORMS], [jax_tf.VideoTransform(**kw) for kw in TRANSFORMS]


def _datasets(tmp_path, kind, **kw):
    align, chat, media = _write_dataset(tmp_path, **kw)
    ours, theirs = _transforms()
    if kind == "align":
        return (AlignVideoDataset(align, media, media, ours, tiny_llm_backbone(device="cpu").tokenizer, NUM_FRAMES),
                JaxAlign(align, media, media, theirs, jax_tiny_llm().tokenizer, num_frames=NUM_FRAMES))
    port_llm, jax_llm = tiny_llm_backbone(device="cpu"), jax_tiny_llm()
    return (FinetuneVideoDataset(chat, media, media, ours, port_llm.tokenizer, port_llm.prompt_builder_fn, NUM_FRAMES),
            JaxFinetune(chat, media, media, theirs, jax_llm.tokenizer, prompt_builder_fn=jax_llm.prompt_builder_fn,
                        num_frames=NUM_FRAMES))


def _assert_items_equal(a, b):
    assert set(a) == set(b)
    np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
    np.testing.assert_array_equal(a["labels"], b["labels"])
    assert a["input_ids"].dtype == b["input_ids"].dtype and a["labels"].dtype == b["labels"].dtype
    assert a["is_image"] == b["is_image"]
    for x, y in zip(a["video_values"], b["video_values"]):
        if y is None:
            assert x is None
        else:
            assert x.dtype == y.dtype == np.uint8 and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind", ["align", "finetune"])
def test_dataset_items_match_merv_tpu(kind, tmp_path):
    """Every item: ids, labels, is_image and each tower's uint8 frames at its
    geometry ([F_e, S, S, 3]; None for text-only rows)."""
    ours, theirs = _datasets(tmp_path, kind)
    assert len(ours) == len(theirs) == 8
    for i in range(len(ours)):
        _assert_items_equal(ours[i], theirs[i])
    item = ours[0]
    assert [v.shape for v in item["video_values"]] == [(4, 32, 32, 3), (2, 24, 24, 3), (4, 16, 16, 3)]
    assert item["labels"][0] == IGNORE_INDEX and ours[7]["video_values"] == [None, None, None]
    assert ours[4]["is_image"] and not ours[0]["is_image"]


def test_finetune_masks_human_turns(tmp_path):
    """Human turns are IGNORE_INDEX whole and gpt turns are supervised as
    their tokens: the labels are the ids where not masked, and each masked
    run is a human turn's tokenization."""
    ours, _ = _datasets(tmp_path, "finetune", turns=3)
    llm = tiny_llm_backbone(device="cpu")
    for i in (0, 7):  # a video conversation (label 0 masked too) and a text-only one
        item = ours[i]
        ids, labels = item["input_ids"], item["labels"]
        supervised = labels != IGNORE_INDEX
        np.testing.assert_array_equal(labels[supervised], ids[supervised])
        builder = llm.prompt_builder_fn(model_family="merv")
        at = 0
        for t, turn in enumerate(ours.examples[i]["conversations"]):
            n = len(llm.tokenizer(builder.add_turn(turn["from"], turn["value"]).rstrip(),
                                  add_special_tokens=t == 0).input_ids)
            assert (labels[at:at + n] == IGNORE_INDEX).all() == (t % 2 == 0 or at == 0), (i, t)
            at += n
        assert at == len(ids)


@pytest.mark.parametrize("kind", ["align", "finetune"])
def test_modality_lengths_match_merv_tpu(kind, tmp_path):
    ours, theirs = _datasets(tmp_path, kind)
    assert ours.get_modality_lengths() == theirs.get_modality_lengths()
    assert [m for m, _ in ours.get_modality_lengths()] == [True] * 6 + [False] * 2


@pytest.mark.parametrize("kind", ["align", "finetune"])
def test_collated_batches_match_merv_tpu(kind, tmp_path):
    """The collator over dataset items, a text-only row among them (its dummy
    zero videos at each tower's host geometry)."""
    from merv_tpu.util.data_utils import PaddedCollatorForLanguageModeling as JaxCollator

    from merv_tpu_torch.util.data_utils import PaddedCollatorForLanguageModeling

    ours, theirs = _datasets(tmp_path, kind)
    port_tf, jax_tfs = _transforms()
    res = mat.host_video_resolutions(port_tf, NUM_FRAMES)
    assert res == jax_mat.host_video_resolutions(jax_tfs, NUM_FRAMES) == [(4, 32, 32, 3), (2, 24, 24, 3), (4, 16, 16, 3)]
    rows = [0, 4, 7, 2]
    out = PaddedCollatorForLanguageModeling(96, 0, res)([ours[i] for i in rows])
    ref = JaxCollator(96, 0, res)([theirs[i] for i in rows])
    assert set(out) == set(ref)
    for key in ref:
        if key == "video_values":
            for a, b in zip(out[key], ref[key]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(out[key], ref[key])
    assert list(out["is_multimodal"]) == [True, True, False, True] and out["video_values"][1][2].sum() == 0


def test_split_modality_sampler_batches(tmp_path):
    """SplitModalitySampler over a finetune dataset's modality lengths: the
    same order as merv_tpu's, every index once, each global batch of one
    modality."""
    ours, theirs = _datasets(tmp_path, "finetune", n_video=6, n_image=2, n_text=8)
    lengths = ours.get_modality_lengths()
    for epoch in (0, 1):
        got = SplitModalitySampler(ours, lengths, global_batch_size=4, num_replicas=1, rank=0, seed=3)
        ref = JaxSplitModalitySampler(theirs, theirs.get_modality_lengths(), global_batch_size=4, num_replicas=1,
                                      rank=0, seed=3)
        got.set_epoch(epoch)
        ref.set_epoch(epoch)
        order = list(got)
        assert order == list(ref) and sorted(order) == list(range(len(ours)))
        for i in range(0, len(order), 4):
            assert len({lengths[j][0] for j in order[i:i + 4]}) == 1


@pytest.mark.parametrize("stage", sorted(mat.DATASET_INITIALIZER))
def test_every_stage_maps_to_its_dataset(stage, tmp_path):
    """Each stage string builds merv_tpu's dataset class for it from the
    dataset config's components, with the collator at the tokenizer's length."""
    assert mat.DATASET_INITIALIZER[stage].__name__ == jax_mat.DATASET_INITIALIZER[stage].__name__
    align, chat, media = _write_dataset(tmp_path)
    cfg = DatasetConfig.get_choice_class("videollava")(
        dataset_root_dir=tmp_path, align_stage_components=(Path("align.json"), Path("media")),
        finetune_stage_components=(Path("chat.json"), Path("media")))
    llm = tiny_llm_backbone(device="cpu")
    ours, _ = _transforms()
    dataset, collator = mat.get_dataset_and_collator(stage, cfg, ours, llm.tokenizer, llm.prompt_builder_fn, NUM_FRAMES)
    assert type(dataset) is mat.DATASET_INITIALIZER[stage] and len(dataset) == 8
    assert dataset.chat_json == align if stage.endswith("align") else dataset.instruct_json == chat
    assert collator.model_max_length == llm.tokenizer.model_max_length
    assert collator.default_video_resolutions == mat.host_video_resolutions(ours, NUM_FRAMES)


def test_unknown_stage_is_refused(tmp_path):
    with pytest.raises(ValueError, match="not supported"):
        mat.get_dataset_and_collator("bogus", DatasetConfig.get_choice_class("videollava")(), [], None, None, [])


def test_dataset_config_matches_merv_tpu():
    """The registry's variants and their encoded configs, as config.json holds them."""
    assert [v.dataset_id for v in DatasetRegistry] == [v.dataset_id for v in jax_conf.DatasetRegistry]
    ours = DatasetConfig.get_choice_class("videollava")()
    theirs = jax_conf.DatasetConfig.get_choice_class("videollava")()
    assert draccus.encode(ours) == jax_draccus.encode(theirs)
    back = draccus.decode(DatasetConfig.get_choice_class("videollava"), draccus.encode(ours))
    assert back == ours


@pytest.mark.parametrize("kw", [TRANSFORMS[0], TRANSFORMS[1], TRANSFORMS[2],
                                dict(target_size=20, resize_strategy="resize-crop", interpolation="bicubic")],
                         ids=["naive", "crop", "letterbox", "crop_tall"])
@pytest.mark.parametrize("shape", [(3, 48, 64, 3), (2, 70, 30, 3)], ids=["wide", "tall"])
def test_host_geometry_matches_merv_tpu(kw, shape):
    video = np.random.RandomState(sum(shape)).randint(0, 256, shape).astype(np.uint8)
    out = tf.VideoTransform(**kw).host_geometry(video)
    ref = jax_tf.VideoTransform(**kw).host_geometry(video)
    assert out.dtype == np.uint8 and out.shape == (shape[0], kw["target_size"], kw["target_size"], 3)
    np.testing.assert_array_equal(out, ref)


# ---------------------------------------------------------------------------
# preprocessing/download.py: the local half (extraction, conversion)
# ---------------------------------------------------------------------------


def test_zip_path_traversal_rejected(tmp_path):
    evil = tmp_path / "evil.zip"
    with zipfile.ZipFile(evil, "w") as z:
        z.writestr("ok.txt", "fine")
        z.writestr("../escape.txt", "bad")
    with pytest.raises(ValueError, match="escapes"):
        download.extract_with_progress(evil, tmp_path / "out", "zip")
    assert not (tmp_path / "escape.txt").exists() and not (tmp_path / "out").exists()


def test_tar_path_traversal_rejected(tmp_path):
    evil = tmp_path / "evil.tar"
    inner = tmp_path / "payload.txt"
    inner.write_text("bad")
    with tarfile.open(evil, "w") as t:
        t.add(inner, arcname="../../escape.txt")
    with pytest.raises(Exception):  # python 3.12's "data" filter raises OutsideDestinationError
        download.extract_with_progress(evil, tmp_path / "out", "tar")
    assert not (tmp_path.parent / "escape.txt").exists()


@pytest.mark.parametrize("extract_type", ["directory", "file"])
def test_benign_archives_extract_as_merv_tpu(extract_type, tmp_path):
    ok = tmp_path / "ok.zip"
    with zipfile.ZipFile(ok, "w") as z:
        z.writestr("a/b.txt", "hello")
        z.writestr("a/c/d.txt", "there")
    out = download.extract_with_progress(ok, tmp_path / "out", extract_type)
    ref = jax_download.extract_with_progress(ok, tmp_path / "ref", extract_type)
    assert out.relative_to(tmp_path / "out") == ref.relative_to(tmp_path / "ref")
    assert (tmp_path / "out" / "a" / "b.txt").read_text() == "hello"
    assert (tmp_path / "out" / "a" / "c" / "d.txt").read_text() == "there"


def test_convert_to_jpg_matches_merv_tpu(tmp_path):
    """PNG and GIF images get a JPG beside them, byte for byte merv_tpu's; JPGs
    and directories are left alone."""
    rng = np.random.RandomState(6)
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    Image.fromarray(rng.randint(0, 256, (20, 30, 3), dtype=np.uint8)).save(src / "a.png")
    Image.fromarray(rng.randint(0, 256, (20, 30), dtype=np.uint8)).convert("P").save(src / "b.gif")
    Image.fromarray(rng.randint(0, 256, (20, 30, 3), dtype=np.uint8)).save(src / "c.jpg")
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    shutil.copytree(src, ours)
    shutil.copytree(src, theirs)
    download.convert_to_jpg(ours)
    jax_download.convert_to_jpg(theirs)
    names = sorted(p.name for p in ours.iterdir())
    assert names == sorted(p.name for p in theirs.iterdir()) == ["a.jpg", "a.png", "b.gif", "b.jpg", "c.jpg", "sub"]
    for name in ("a.jpg", "b.jpg", "c.jpg"):
        assert (ours / name).read_bytes() == (theirs / name).read_bytes()


def test_download_registry_matches_merv_tpu():
    """The component table: every dataset, name, URL and flag as merv_tpu lists it."""
    assert download.DATASET_REGISTRY == jax_download.DATASET_REGISTRY
