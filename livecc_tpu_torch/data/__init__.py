from livecc_tpu_torch.data import chat, lmm_dataset
from livecc_tpu_torch.data.lmm_dataset import LMMDataset, write_seek_index
from livecc_tpu_torch.data.tokenizer import ByteTokenizer, HFTokenizer, load_tokenizer

__all__ = ["chat", "lmm_dataset", "LMMDataset", "write_seek_index", "ByteTokenizer",
           "HFTokenizer", "load_tokenizer"]
