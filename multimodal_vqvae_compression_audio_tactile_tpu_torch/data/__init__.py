from .pairs import list_wavs, pair_stems, split_items  # noqa: F401
