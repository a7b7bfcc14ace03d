"""F1 on the card: the port's fp32 entry points compute in true fp32 without
``StreamingCodec`` and without changing TF32 for the rest of the process.

Marked ``cuda``: each test skips without a card. Each run is a fresh
subprocess with TF32 left at PyTorch's default (cuDNN convolutions in TF32).
The file imports neither jax nor the JAX package, so it also runs on a
machine with the card, which has neither:

    python -m pytest --noconftest tests/test_torch_precision_cuda.py -q
"""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "multimodal_vqvae_compression_audio_tactile_tpu_torch"

_ENCODE = f"""
import numpy as np, torch
from {PORT}.core.config import CodecConfig
from {PORT}.models import allpred_ar
default = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
assert default[0], "cuDNN TF32 is not PyTorch's default here"
m = allpred_ar.codec_init(CodecConfig().tiny(), torch.Generator().manual_seed(0)).cuda().eval()
a, tc = (torch.from_numpy(x).cuda() for x in
         (0.1 * np.random.default_rng(0).standard_normal((2, 1, 1, 4800))).astype(np.float32))
z, codes = allpred_ar.encode_latents(m, a, tc)
y = allpred_ar.decode_from_codes(m, a, codes)
assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == default
torch.backends.cudnn.allow_tf32 = False          # the pinned reference
torch.backends.cuda.matmul.allow_tf32 = False
z_ref, codes_ref = allpred_ar.encode_latents(m, a, tc)
y_ref = allpred_ar.decode_from_codes(m, a, codes_ref)
rel = lambda g, r: float((g - r).abs().max() / r.abs().max())
print("LATENT_REL", rel(z, z_ref), "WAVE_REL", rel(y, y_ref), "CODES", bool(torch.equal(codes, codes_ref)))
assert rel(z, z_ref) <= 1e-5 and rel(y, y_ref) <= 1e-5 and torch.equal(codes, codes_ref)
"""

_SERVING = f"""
import numpy as np, torch
from {PORT}.core.config import CodecConfig
from {PORT}.eval.serving import StreamingCodec
from {PORT}.models import allpred_ar
default = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
m = allpred_ar.codec_init(CodecConfig().tiny(), torch.Generator().manual_seed(0))
sc = StreamingCodec(m, batch=1, frame_sec=0.2, compute_dtype=torch.float32)
sc.decode(sc.encode(*np.zeros((2, 1, 1, 4800), np.float32))[0])
assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == default
print("SETTINGS_KEPT")
"""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    return torch.device("cuda")


def _run(code):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)


@pytest.mark.cuda
def test_fp32_entry_points_match_the_pinned_path_with_tf32_at_default(cuda):
    """encode_latents and decode_from_codes in fp32, called directly: latents
    and waveform within 1e-5 of a run with TF32 off for the whole process,
    the same codes, and PyTorch's settings as they were."""
    proc = _run(_ENCODE)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]


@pytest.mark.cuda
def test_streaming_codec_leaves_the_tf32_settings_alone(cuda):
    proc = _run(_SERVING)
    assert proc.returncode == 0 and "SETTINGS_KEPT" in proc.stdout, proc.stderr[-3000:]
