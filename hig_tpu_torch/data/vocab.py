"""NTU RGB+D mutual-action caption strings (own copy of the caption table in
``hig_tpu/data/vocab.py``: labels of the public dataset, not code).

Asymmetric actions have (active, passive) caption pairs; symmetric ones a
single caption → 43 caption strings in ``CAPS``. ``CAP2KEY`` maps a caption
to its index in ``CAPS`` (the row of the precomputed CLIP features),
``CAP2CLASSID`` an active caption to its class index 0..25.
"""

from __future__ import annotations

NTU_ACTION_MULTI = {
    50: ["A person is punching or slapping the other person.",
         "A person is punched or slapped by the other person."],
    51: ["A person is kicking the other person.",
         "A person is kicked by the other person."],
    52: ["A person is pushing the other person.",
         "A person is pushed by the other person."],
    53: ["A person is patting on the back of the other person.",
         "A person is patted on the back by the other person."],
    54: ["A person is pointing a finger at the other person.",
         "A person has a finger pointed at by the other person."],
    55: ["A person is hugging the other person."],
    56: ["A person is giving something to the other person.",
         "A person is given something by the other person."],
    57: ["A person is touching the other person's pocket.",
         "A person has a pocket touched by the other person."],
    58: ["A person is shaking hands with the other person."],
    59: ["A person is walking towards the other person."],
    60: ["A person is walking apart from the other person."],
    106: ["A person is hitting the other person with something.",
          "A person is hit by the other person with something."],
    107: ["A person is wielding a knife at the other person.",
          "A person has a knife pointed at by the other person."],
    108: ["A person is knocking over the other person.",
          "A person is knocked over by the other person."],
    109: ["A person is grabbing the other person's stuff.",
          "A person has a stuff grabbed by the other person."],
    110: ["A person is shooting at the other person with a gun.",
          "A person is shot at with a gun by the other person."],
    111: ["A person is stepping on the other person's foot.",
          "A person has a foot stepped on foot by the other person."],
    112: ["A person is doing a high-five with the other person."],
    113: ["A person is cheering and drinking with the other person."],
    114: ["A person is carrying something with the other person."],
    115: ["A person is taking a photo of the other person.",
          "A person has a photo taken by the other person."],
    116: ["A person is following the other person.",
          "A person is followed by the other person."],
    117: ["A person is whispering in the other person's ear.",
          "A person is being whispered to by the other person."],
    118: ["A person is exchanging things with the other person."],
    119: ["A person is supporting the other person with a hand.",
          "A person is supported with a hand by the other person."],
    120: ["A person is doing finger-guessing game with the other person."],
}

CAPS: list[str] = [cap for caps in NTU_ACTION_MULTI.values() for cap in caps]
CAP2KEY: dict[str, int] = {cap: i for i, cap in enumerate(CAPS)}
CAP2CLASSID: dict[str, int] = {
    caps[0]: class_id for class_id, caps in enumerate(NTU_ACTION_MULTI.values())
}
NUM_CLASSES = len(NTU_ACTION_MULTI)  # 26

# class id → (active caption, passive caption); symmetric classes repeat.
CLASSID2CAPS: list[tuple[str, str]] = [
    (caps[0], caps[-1]) for caps in NTU_ACTION_MULTI.values()
]
