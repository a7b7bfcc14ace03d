"""PyTorch/CUDA port of the multimodal VQ-VAE codec, for NVIDIA Hopper.

The JAX package ``multimodal_vqvae_compression_audio_tactile_tpu`` is the
reference; this package imports nothing from it (nor jax, flax or msgpack),
so it runs on a machine that has only PyTorch, numpy and the CUDA toolkit.

Layout: ``core/config.py`` (configuration), ``utils/msgpack_read.py`` and
``train/checkpoint.py`` (reading the JAX checkpoints), ``convert.py`` (JAX
parameter tree -> modules), ``models/`` (DAC backbone, AllPredAR codec),
``nn/layers.py`` (predictor blocks), ``ops/`` (head RVQ, the time-major
convs, and the wrappers of the three CUDA kernels, whose sources are in
``csrc/``: the channels-first residual-unit stack K1, the time-major one K3
and the fused residual-VQ lookup K2), ``eval/`` (bitstream, metrics and the
streaming serving wrappers, the codec's and the concealer's, whose layout
options choose K1 or K3 for each stack), ``plc/`` (packet-loss masks, the
concealment model, its evaluators), ``dsp/`` (STFT, mel, resampling,
alignment), ``data/pairs.py`` and ``utils/`` (WAV and run-artifact files).

Entry points take ``device=None``, which means CUDA; they run on the CPU only
when the caller passes ``device="cpu"``.
"""
