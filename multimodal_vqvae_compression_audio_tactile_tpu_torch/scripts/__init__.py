"""Entry points, run as ``python -m multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts.<name>``."""
