"""Tokenizers with the LASR special-token protocol (counterpart of
``lasr_tpu/data/tokenizer.py``).

The id protocol (BLANK=0, SOS=1, EOS=2, MASK=3, PAD=4, UNK=5, IGNORE=-1)
is what the CTC blank, beam-search sos/eos and loss padding key off.
``HuggingTokenizer`` needs the optional ``tokenizers`` package and raises
when it is missing.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from lasr_tpu_torch.data import reader

try:
    from tokenizers import Tokenizer as _HFTokenizer
except ImportError:  # pragma: no cover
    _HFTokenizer = None


class BaseTokenizer:
    ID_VALUE_BLANK = 0
    ID_VALUE_SOS = 1
    ID_VALUE_EOS = 2
    ID_VALUE_MASK = 3
    ID_VALUE_PAD = 4
    ID_VALUE_UNK = 5
    ID_VALUE_IGNORE = -1
    ID_VALUE_BLACK = 0   # the reference's spelling

    ID_KEY_BLANK = "<BLANK>"
    ID_KEY_SOS = "<SOS>"
    ID_KEY_EOS = "<EOS>"
    ID_KEY_MASK = "[MASK]"
    ID_KEY_PAD = "[PAD]"
    ID_KEY_UNK = "[UNK]"
    ID_KEY_BLACK = "<BLANK>"

    SPECIAL_VALUE = [0, 1, 2, 3, 4, 5]
    SPECIAL_KEY = [ID_KEY_BLANK, ID_KEY_SOS, ID_KEY_EOS, ID_KEY_MASK,
                   ID_KEY_PAD, ID_KEY_UNK]

    def get_token_id(self, token: str) -> int:
        raise NotImplementedError

    def get_id_token(self, idx: int) -> str:
        raise NotImplementedError

    def encode(self, text: str, add_sos_eos: bool = True
               ) -> Tuple[List[str], List[int]]:
        raise NotImplementedError

    def decode(self, token_id: Sequence[int], no_special: bool = False
               ) -> Tuple[List[str], str]:
        raise NotImplementedError

    def dict_size(self) -> int:
        raise NotImplementedError

    def strip_special(self, token_id: Sequence[int]) -> List[int]:
        return [t for t in token_id if t not in self.SPECIAL_VALUE]


class CharTokenizer(BaseTokenizer):
    """Character (or separator-split) tokenizer over a dict file."""

    def __init__(self, dict_path: str, sc: str = "") -> None:
        self.sc = sc
        self.char_list = list(self.SPECIAL_KEY) + reader.read_list(dict_path)
        self.char_dict = {c: i for i, c in enumerate(self.char_list)}

    def get_token_id(self, token: str) -> int:
        return self.char_dict.get(token.upper(),
                                  self.char_dict[self.ID_KEY_UNK])

    def get_id_token(self, idx: int) -> str:
        if idx >= len(self.char_list):
            return self.ID_KEY_UNK
        return self.char_list[idx]

    def encode(self, text, add_sos_eos=True):
        tokens = list(text) if not self.sc else text.split(self.sc)
        if add_sos_eos:
            tokens = [self.ID_KEY_SOS] + tokens + [self.ID_KEY_EOS]
        return tokens, [self.get_token_id(t) for t in tokens]

    def decode(self, token_id, no_special=False):
        ids = list(token_id)
        if no_special:
            ids = self.strip_special(ids)
        tokens = [self.get_id_token(i) for i in ids]
        return tokens, self.sc.join(tokens)

    def dict_size(self) -> int:
        return len(self.char_list)


class HuggingTokenizer(BaseTokenizer):
    """HF ``tokenizers`` JSON model (WordPiece '##' continuation)."""

    def __init__(self, dict_path: str, sc: str = "##") -> None:
        if _HFTokenizer is None:
            raise ImportError("the `tokenizers` package is required")
        self.tokenizer = _HFTokenizer.from_file(dict_path)
        self.char_dict = self.tokenizer.get_vocab()
        self.sc = sc

    def get_token_id(self, token: str) -> int:
        return self.tokenizer.token_to_id(token.upper())

    def get_id_token(self, idx: int) -> str:
        return self.tokenizer.id_to_token(idx)

    def dict_size(self) -> int:
        return self.tokenizer.get_vocab_size()

    def encode(self, text, add_sos_eos=True):
        out = self.tokenizer.encode(text.upper())
        tokens, ids = out.tokens, out.ids
        if add_sos_eos:
            tokens = [self.ID_KEY_SOS] + tokens + [self.ID_KEY_EOS]
            # reference quirk: SOS id at both ends (tokenizer.py:150)
            ids = [self.ID_VALUE_SOS] + ids + [self.ID_VALUE_SOS]
        return tokens, ids

    def decode(self, token_id, no_special=False):
        ids = list(token_id)
        if no_special:
            ids = self.strip_special(ids)
        tokens = [self.get_id_token(i) for i in ids]
        return tokens, self.tokenizer.decode(ids).replace(" " + self.sc, "")

    @staticmethod
    def train_tokenizer(train_file, save_path, vocab_size=5000):
        """Train a WordPiece model over whitespace pre-tokens of the text
        file(s) ``train_file`` (the special tokens first) and save it as
        ``save_path`` (pretty JSON)."""
        from tokenizers import Tokenizer
        from tokenizers.models import WordPiece
        from tokenizers.pre_tokenizers import Whitespace
        from tokenizers.trainers import WordPieceTrainer
        tok = Tokenizer(WordPiece(unk_token=BaseTokenizer.ID_KEY_UNK))
        tok.pre_tokenizer = Whitespace()
        trainer = WordPieceTrainer(special_tokens=BaseTokenizer.SPECIAL_KEY,
                                   vocab_size=vocab_size)
        tok.train(files=train_file, trainer=trainer)
        tok.save(save_path, pretty=True)
