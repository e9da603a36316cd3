"""Token <-> id vocabulary encoder (the port's copy of
``prodiff_tpu/utils/text_encoder.py``, as far as the port uses it).

Ids 0/1/2 are reserved for ``<pad>/<EOS>/<UNK>``, vocab entries follow, and
out-of-vocabulary tokens are replaced by a configurable token (the SVS
pipeline uses ``SP``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

RESERVED_TOKENS = ["<pad>", "<EOS>", "<UNK>"]


class TokenTextEncoder:
    def __init__(self, vocab_list: Sequence[str], replace_oov: Optional[str] = None):
        self._replace_oov = replace_oov
        self._id_to_token = RESERVED_TOKENS + list(vocab_list)
        self._token_to_id = {t: i for i, t in enumerate(self._id_to_token)}

    def __len__(self) -> int:
        return len(self._id_to_token)

    def encode(self, s) -> List[int]:
        """Encode a space-separated string or a token list into ids."""
        sentence = s.split(" ") if isinstance(s, str) else list(s)
        if self._replace_oov is not None:
            sentence = [t if t in self._token_to_id else self._replace_oov for t in sentence]
        return [self._token_to_id[t] for t in sentence]

    def decode(self, ids: Sequence[int]) -> str:
        return " ".join(self._id_to_token[i] for i in ids)

    def id(self, token: str) -> int:
        return self._token_to_id[token]
