from .pairs import list_wavs, pair_stems, split_items  # noqa: F401
from .segments import SegmentDataset  # noqa: F401
from .loader import batch_iterator  # noqa: F401
