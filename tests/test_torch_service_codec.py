"""The port's HTTP app on the real codec, ``device="cpu"`` (the kernels'
plain versions), at small sizes: a load-image request stores in the fake
bucket exactly the bytes of the port's encoder; region reads, coefficient
reads and tensor routes answer with what the JAX package computes from
the same bytes; a bfloat16 tensor's body is byte-equal to the JAX app's,
and a ``<V2`` body is refused by both apps alike.

Images are 40x48 RGB at low amplitude: the plain Tier-1 versions cost
seconds per encode on the CPU."""
import asyncio
import io
import os

import ml_dtypes
import numpy as np
import pytest

from bucketeer_tpu import config as j_cfg
from bucketeer_tpu import features as j_features
from bucketeer_tpu import tensor as j_tensor
from bucketeer_tpu.engine import Engine as JEngine
from bucketeer_tpu.engine import FakeS3Client as JFakeS3
from bucketeer_tpu.engine import RecordingSlackClient as JSlack
from bucketeer_tpu.server.app import build_app as j_build_app
from bucketeer_tpu.tensor import coeffs as j_coeffs
from bucketeer_tpu_torch import config as t_cfg
from bucketeer_tpu_torch import features as t_features
from bucketeer_tpu_torch.codec import encoder as t_encoder
from bucketeer_tpu_torch.converters import (Conversion, CudaConverter,
                                            output_path)
from bucketeer_tpu_torch.engine import Engine as TEngine
from bucketeer_tpu_torch.engine import FakeS3Client as TFakeS3
from bucketeer_tpu_torch.engine import RecordingSlackClient as TSlack
from bucketeer_tpu_torch.server.app import build_app as t_build_app

H, W = 40, 48


def _image(seed):
    """Low-amplitude RGB content: few bit planes, a quick plain encode."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    base = 120 + 6 * np.sin(x / 5.0) * np.cos(y / 7.0)
    img = base[..., None] + rng.integers(0, 4, (H, W, 3))
    return img.astype(np.uint8)


def _config(cfg, root, overrides=None):
    return cfg.Config.load(overrides={
        cfg.IIIF_URL: "http://iiif.test/iiif",
        cfg.SLACK_CHANNEL_ID: "chan",
        cfg.FILESYSTEM_CSV_MOUNT: str(root / "csv-mount"),
        cfg.FILESYSTEM_IMAGE_MOUNT: str(root),
        cfg.S3_REQUEUE_DELAY: 0.01, **(overrides or {})})


def _torch_app(root, overrides=None):
    """The port's app on its real converter, on the CPU, with the card's
    default Tier-1 (the fused kernel's plain version): a converter of
    its own, so the setting reaches no other test's."""
    engine = TEngine(_config(t_cfg, root, overrides),
                     flags=t_features.FeatureFlagChecker(static={}),
                     converter=CudaConverter(device="cpu", device_mq=True),
                     s3_client=TFakeS3(str(root / "s3")),
                     slack_client=TSlack(), device="cpu")
    return t_build_app(engine), engine


class _NoConvert:
    def convert(self, image_id, source_path, conversion=None):
        raise AssertionError("the JAX app converts nothing here")


def _jax_app(root):
    engine = JEngine(_config(j_cfg, root),
                     flags=j_features.FeatureFlagChecker(static={}),
                     converter=_NoConvert(),
                     s3_client=JFakeS3(str(root / "s3")),
                     slack_client=JSlack())
    return j_build_app(engine), engine


async def _wait(predicate, rounds=1500, delay=0.02):
    for _ in range(rounds):
        if predicate():
            return True
        await asyncio.sleep(delay)
    return False


@pytest.fixture
def tmpdir_env(tmp_path, monkeypatch):
    monkeypatch.setenv("BUCKETEER_TMPDIR", str(tmp_path / "work"))
    (tmp_path / "work").mkdir()
    return tmp_path


async def _stored_object(engine):
    """The one object in the engine's fake bucket, once uploaded."""
    assert await _wait(lambda: engine.s3_client.metadata)
    assert await _wait(lambda: not engine.image_worker.background)
    (key,) = engine.s3_client.metadata
    with open(os.path.join(engine.s3_client.root, key), "rb") as fh:
        return fh.read()


async def _check_reads(client, image_id, stored, img, lossless):
    """Region and coefficient reads of the stored derivative: the region
    is the source crop (lossless) and the coefficient npz equals the JAX
    package's decode_to_coefficients of the same bytes."""
    # The upload path removes the local derivative: put it back for the
    # read routes.
    with open(output_path(image_id, ".jpx"), "wb") as fh:
        fh.write(stored)
    quoted = image_id.replace(":", "%3A").replace("/", "%2F")
    x, y, w, h = 8, 4, 24, 20
    resp = await client.get(
        f"/images/{quoted}?format=raw&region={x},{y},{w},{h}")
    assert resp.status == 200
    crop = np.load(io.BytesIO(await resp.read()))
    assert crop.shape == (h, w, 3)
    if lossless:
        np.testing.assert_array_equal(crop, img[y:y + h, x:x + w])
    resp = await client.get(f"/images/{quoted}/coefficients")
    assert resp.status == 200
    got = dict(np.load(io.BytesIO(await resp.read())))
    ref = j_coeffs.decode_to_coefficients(stored).to_host()
    assert sorted(got) == sorted(f"r{r}_{n}" for r, n in ref)
    for (r, n), arr in ref.items():
        np.testing.assert_array_equal(got[f"r{r}_{n}"], arr)


async def test_load_image_uploads_the_encoders_bytes(tmpdir_env,
                                                     aiohttp_client):
    """GET /images/{id}/{path} on the real CudaConverter(device="cpu")
    (lossless, the worker's default): the fake bucket holds exactly
    encode_jp2(..., device="cpu") of the TIFF under the converter's
    recipe; then the region and coefficient reads of it."""
    from PIL import Image

    img = _image(3)
    src = tmpdir_env / "src.tif"
    Image.fromarray(img).save(src)
    app, engine = _torch_app(tmpdir_env)
    client = await aiohttp_client(app)
    resp = await client.get(f"/images/ark%3A%2F7%2Fimg/{src}")
    assert resp.status == 201, await resp.text()
    stored = await _stored_object(engine)
    assert isinstance(engine.converter, CudaConverter)
    params = engine.converter.encode_params(H, W, 8, Conversion.LOSSLESS)
    assert stored == t_encoder.encode_jp2(img, 8, params, jpx=True,
                                          device="cpu")
    await _check_reads(client, "ark:/7/img", stored, img, lossless=True)
    await client.close()


async def test_csv_batch_uploads_the_encoders_bytes(tmpdir_env,
                                                    aiohttp_client):
    """A one-item CSV job with the lossy conversion configured: the batch
    converter stores exactly the lossy encode_jp2 bytes, the job
    finalizes SUCCEEDED; then the reads of the lossy derivative."""
    from aiohttp import FormData
    from PIL import Image

    img = _image(4)
    Image.fromarray(img).save(tmpdir_env / "item.tif")
    app, engine = _torch_app(tmpdir_env,
                             {t_cfg.CONVERSION_TYPE: "lossy"})
    client = await aiohttp_client(app)
    form = FormData()
    form.add_field("csvFileToUpload",
                   b"Item ARK,File Name\nark:/7/lossy,item.tif\n",
                   filename="codec-job.csv", content_type="text/csv")
    form.add_field("slack-handle", "tester")
    resp = await client.post("/batch/input/csv", data=form)
    assert resp.status == 200, await resp.text()
    assert await _wait(lambda: "codec-job" not in engine.store)
    stored = await _stored_object(engine)
    params = engine.converter.encode_params(H, W, 8, Conversion.LOSSY)
    assert stored == t_encoder.encode_jp2(img, 8, params, jpx=True,
                                          device="cpu")
    (message,) = engine.slack_client.messages
    assert "codec-job" in message["text"]
    assert "succeeded" in message["content"]
    await _check_reads(client, "ark:/7/lossy", stored, img, lossless=False)
    await client.close()


@pytest.mark.parametrize("dtype,values", [
    ("int8", lambda rng: rng.integers(-3, 4, (2, 40)).astype(np.int8)),
    ("float32", lambda rng: rng.choice(
        np.array([0.0, 0.5, -1.0, 2.0], np.float32), (24,))),
])
async def test_tensor_post_get_round_trip(dtype, values, tmpdir_env,
                                          aiohttp_client):
    """POST /tensors then GET /tensors on the port's app: the stored
    blob is the JAX encode_tensor's bytes, and the GET body round-trips
    the tensor exactly."""
    arr = values(np.random.default_rng(11))
    app, _ = _torch_app(tmpdir_env)
    client = await aiohttp_client(app)
    buf = io.BytesIO()
    np.save(buf, arr)
    resp = await client.post(f"/tensors/t-{dtype}", data=buf.getvalue())
    assert resp.status == 201, await resp.text()
    assert (await resp.json())["tensor-id"] == f"t-{dtype}"
    with open(output_path(f"t-{dtype}", ".btt"), "rb") as fh:
        blob = fh.read()
    assert blob == j_tensor.encode_tensor(arr, device="host")
    resp = await client.get(f"/tensors/t-{dtype}")
    assert resp.status == 200
    assert resp.headers["X-Tensor-Dtype"] == dtype
    back = np.load(io.BytesIO(await resp.read()))
    assert back.dtype == arr.dtype
    np.testing.assert_array_equal(back.view(np.uint8), arr.view(np.uint8))
    resp = await client.get(f"/tensors/t-{dtype}?format=blob")
    assert await resp.read() == blob
    await client.close()


async def test_bfloat16_get_body_equals_jax_app(tmpdir_env,
                                                aiohttp_client):
    """A stored bfloat16 blob: both apps answer GET /tensors/{id} with
    the same bytes (a ``<V2`` npy) and the same headers."""
    rng = np.random.default_rng(12)
    arr = rng.normal(0, 2, (3, 7)).astype(ml_dtypes.bfloat16)
    arr[0, 0] = -0.0
    blob = j_tensor.encode_tensor(arr, device="host")
    with open(output_path("t-bf16", ".btt"), "wb") as fh:
        fh.write(blob)
    bodies = []
    for build in (_jax_app, _torch_app):
        root = tmpdir_env / build.__name__
        root.mkdir()
        app, _ = build(root)
        client = await aiohttp_client(app)
        resp = await client.get("/tensors/t-bf16")
        assert resp.status == 200
        bodies.append((await resp.read(), resp.headers["X-Tensor-Dtype"],
                       resp.headers["X-Tensor-Shape"], resp.content_type))
        await client.close()
    assert bodies[0] == bodies[1]
    assert bodies[1][1:3] == ("bfloat16", "3x7")
    assert np.load(io.BytesIO(bodies[1][0])).dtype == np.dtype("V2")


async def test_v2_post_is_400_in_both_apps(tmpdir_env, aiohttp_client):
    """A ``<V2`` body (what GET serves for bfloat16) is not a tensor
    either codec takes: 400 from both apps, with the same page."""
    arr = np.arange(6, dtype=np.float32).astype(ml_dtypes.bfloat16)
    buf = io.BytesIO()
    np.save(buf, arr)
    answers = []
    for build in (_jax_app, _torch_app):
        root = tmpdir_env / build.__name__
        root.mkdir()
        app, _ = build(root)
        client = await aiohttp_client(app)
        resp = await client.post("/tensors/t-v2", data=buf.getvalue())
        answers.append((resp.status, resp.content_type,
                        await resp.text()))
        await client.close()
    assert answers[0][0] == 400
    assert answers[0] == answers[1]
    assert not os.path.exists(output_path("t-v2", ".btt"))
