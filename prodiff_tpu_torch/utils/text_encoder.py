"""Token <-> id vocabulary encoder (the port's copy of
``prodiff_tpu/utils/text_encoder.py``).

Ids 0/1/2 are reserved for ``<pad>/<EOS>/<UNK>``, vocab entries follow, and
out-of-vocabulary tokens are replaced by a configurable token (the SVS
pipeline uses ``SP``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

RESERVED_TOKENS = ["<pad>", "<EOS>", "<UNK>"]
PAD_ID = 0


class TokenTextEncoder:
    def __init__(self, vocab_list: Sequence[str], replace_oov: Optional[str] = None):
        self._replace_oov = replace_oov
        self._id_to_token = RESERVED_TOKENS + list(vocab_list)
        self._token_to_id = {t: i for i, t in enumerate(self._id_to_token)}

    @property
    def vocab_size(self) -> int:
        return len(self._id_to_token)

    def __len__(self) -> int:
        return self.vocab_size

    def contains(self, token: str) -> bool:
        return token in self._token_to_id

    def encode(self, s) -> List[int]:
        """Encode a space-separated string or a token list into ids."""
        sentence = s.split(" ") if isinstance(s, str) else list(s)
        if self._replace_oov is not None:
            sentence = [t if t in self._token_to_id else self._replace_oov for t in sentence]
        return [self._token_to_id[t] for t in sentence]

    def decode(self, ids: Sequence[int], strip_padding: bool = False) -> str:
        if strip_padding:
            ids = [i for i in ids if i != PAD_ID]
        return " ".join(self._id_to_token[i] for i in ids)

    def token(self, id_: int) -> str:
        return self._id_to_token[id_]

    def id(self, token: str) -> int:
        return self._token_to_id[token]

    def store_to_file(self, filename: str) -> None:
        """The vocabulary, reserved tokens left out, one token a line."""
        with open(filename, "w", encoding="utf-8") as f:
            for tok in self._id_to_token[len(RESERVED_TOKENS):]:
                f.write(tok + "\n")
