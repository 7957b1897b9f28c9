"""Phone inventories and phone<->id mapping.

Behavioral parity with the reference's phoneset extension
(reference: extensions/phoneset/phoneset.py:11-26 and the
us/uscmu/cmu phoneset JSON data files).  The three inventories are embedded as
data; ``Phoneset`` can also load any reference-format JSON file
(``{"phones": [{"id": N, "phone": "..."}]}``).

Duplicate phones in an inventory map to their *last* id, matching the dict
comprehension in the reference loader.
"""

import json
from typing import Dict, List, Union

_US_PHONES = (
    "aa ae ah ao aw ax axr ay b ch d dh dx eh el em en er ey f g hh hv ih iy "
    "jh k l m n nx ng ow oy p r s sh t th uh uw v w y z zh pau h# brth"
).split()

_CMU_PHONES = (
    "pau QQ QM A a: > tra t:ra h: >: A: i i: u u: 9r= 9r: rr= rr r rrh l= @ "
    "@: e: aI >I o: aU oU oI q k kh G g gh x N c ch z z~ J Jh n~ T tB tBh D d "
    "d~ dB dBh n nX nB tr tR dr dR nr p P ph f b bh m M j 9rB 9r l lr lr= V v "
    "c} S sr s h s~ t t~ hv H n: E e o 6 6j 6w 9: 9y E: O: O:j a:j a:w dz dZ "
    "Z ej gw iw kw ow ts tS u:j w y: LB"
).split()

_USCMU_PHONES = _CMU_PHONES + _US_PHONES

BUILTIN_PHONESETS: Dict[str, List[str]] = {
    "us": _US_PHONES,
    "cmu": _CMU_PHONES,
    "uscmu": _USCMU_PHONES,
}


class Phoneset:
    def __init__(self, phoneset: Union[str, List[str]]):
        """``phoneset`` may be a builtin name ('us' | 'cmu' | 'uscmu'), a path
        to a reference-format JSON file, or an explicit phone list."""
        if isinstance(phoneset, list):
            phones = list(enumerate(phoneset))
        elif phoneset in BUILTIN_PHONESETS:
            phones = list(enumerate(BUILTIN_PHONESETS[phoneset]))
        else:
            with open(phoneset) as f:
                parsed = json.load(f)
            phones = [(item["id"], item["phone"]) for item in parsed["phones"]]
        self._phone_to_id = {phone: pid for pid, phone in phones}
        self._id_to_phone = {pid: phone for pid, phone in phones}

    def __len__(self) -> int:
        return len(self._id_to_phone)

    def phone_to_id(self, phone: str) -> int:
        return self._phone_to_id[phone]

    def id_to_phone(self, pid: int) -> str:
        return self._id_to_phone[pid]

    def to_json(self) -> str:
        return json.dumps({
            "phones": [{"id": pid, "phone": ph}
                       for pid, ph in sorted(self._id_to_phone.items())]
        }, indent=2)
