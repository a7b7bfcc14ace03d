"""Dataset extraction: a tree of .mat recordings -> WAV files.

    python -m multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts.extract_dataset \\
        KIND ROOT OUT [SR]

The JAX package's ``scripts/extract_dataset.py`` with its positional
arguments: KIND in {audio, tactile, audio_raw, tactile_raw}; every ``.mat``
under ROOT through ``data/mat_extract.py::extract_corpus`` into OUT, at SR
(default 44100 for audio, 3000 for tactile). Host work only: no model and no
card.
"""

from __future__ import annotations

import sys

from ..data.mat_extract import extract_corpus


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) < 3:
        print(__doc__)
        return 1
    kind, root, out = argv[:3]
    sr = int(argv[3]) if len(argv) > 3 else None
    extract_corpus(root, out, kind, sr=sr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
