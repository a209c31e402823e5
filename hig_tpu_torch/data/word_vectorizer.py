"""GloVe + POS one-hot word vectorizer of the legacy HumanML3D protocol
(own copy of ``hig_tpu/data/word_vectorizer.py``): 'word/POS' tokens →
(300-d GloVe vector, 15-d POS one-hot with the VIP word-class overrides).
The GloVe files (``<prefix>_data.npy``, ``<prefix>_words.pkl``,
``<prefix>_idx.pkl``) are not in the repository; without them each word
gets a deterministic hash vector, equal bit for bit to the JAX package's
(fine for running the protocol, not for quoting its numbers).
"""

from __future__ import annotations

import hashlib
import os
import pickle
from os.path import join as pjoin

import numpy as np

POS_ENUMERATOR = {
    "VERB": 0, "NOUN": 1, "DET": 2, "ADP": 3, "NUM": 4, "AUX": 5, "PRON": 6,
    "ADJ": 7, "ADV": 8, "Loc_VIP": 9, "Body_VIP": 10, "Obj_VIP": 11,
    "Act_VIP": 12, "Desc_VIP": 13, "OTHER": 14,
}

_LOC = ("left", "right", "clockwise", "counterclockwise", "anticlockwise",
        "forward", "back", "backward", "up", "down", "straight", "curve")
_BODY = ("arm", "chin", "foot", "feet", "face", "hand", "mouth", "leg",
         "waist", "eye", "knee", "shoulder", "thigh")
_OBJ = ("stair", "dumbbell", "chair", "window", "floor", "car", "ball",
        "handrail", "baseball", "basketball")
_ACT = ("walk", "run", "swing", "pick", "bring", "kick", "put", "squat",
        "throw", "hop", "dance", "jump", "turn", "stumble", "dance", "stop",
        "sit", "lift", "lower", "raise", "wash", "stand", "kneel", "stroll",
        "rub", "bend", "balance", "flap", "jog", "shuffle", "lean", "rotate",
        "spin", "spread", "climb")
_DESC = ("slowly", "carefully", "fast", "careful", "slow", "quickly",
         "happy", "angry", "sad", "happily", "angrily", "sadly")

VIP_DICT = {
    "Loc_VIP": _LOC, "Body_VIP": _BODY, "Obj_VIP": _OBJ,
    "Act_VIP": _ACT, "Desc_VIP": _DESC,
}

WORD_DIM = 300
POS_DIM = len(POS_ENUMERATOR)


class WordVectorizer:
    """'word/POS' → (GloVe vec, POS one-hot). (ref: word_vectorizer.py:46-79)"""

    def __init__(self, meta_root: str | None = None, prefix: str = "our_vab"):
        self.word2vec: dict[str, np.ndarray] = {}
        self._has_assets = False
        if meta_root and os.path.exists(pjoin(meta_root, f"{prefix}_data.npy")):
            vectors = np.load(pjoin(meta_root, f"{prefix}_data.npy"))
            with open(pjoin(meta_root, f"{prefix}_words.pkl"), "rb") as f:
                words = pickle.load(f)
            with open(pjoin(meta_root, f"{prefix}_idx.pkl"), "rb") as f:
                word2idx = pickle.load(f)
            self.word2vec = {w: vectors[word2idx[w]] for w in words}
            self._has_assets = True

    def _hash_vec(self, word: str) -> np.ndarray:
        seed = int.from_bytes(hashlib.md5(word.encode()).digest()[:4], "little")
        return np.random.RandomState(seed).randn(WORD_DIM).astype(np.float32) * 0.1

    def _pos_onehot(self, pos: str) -> np.ndarray:
        vec = np.zeros(POS_DIM, np.float32)
        vec[POS_ENUMERATOR.get(pos, POS_ENUMERATOR["OTHER"])] = 1.0
        return vec

    def __len__(self) -> int:
        return len(self.word2vec)

    def __getitem__(self, item: str):
        word, pos = item.split("/")
        if self._has_assets:
            if word in self.word2vec:
                word_vec = self.word2vec[word]
            else:
                word_vec = self.word2vec.get("unk", np.zeros(WORD_DIM, np.float32))
                return word_vec, self._pos_onehot("OTHER")
        else:
            word_vec = self._hash_vec(word)
        vip = next((k for k, v in VIP_DICT.items() if word in v), None)
        return word_vec, self._pos_onehot(vip if vip else pos)
