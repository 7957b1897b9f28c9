"""Grapheme-to-phoneme via the external flite binary.

Behavioral parity with the reference's G2P extension
(reference: extensions/flite.py:13-43): shells out to ``flite -ps``, strips
the leading/trailing ``pau`` tokens, and maps phones to ids through a
:class:`~self_attention_tacotron_torch.text.phoneset.Phoneset`.

If the binary is unavailable the caller can gate on :meth:`Flite.available`.
"""

import shutil
import subprocess
from typing import List, Tuple, Union

from .phoneset import Phoneset


class Flite:
    def __init__(self, binary_path: str, phoneset: Union[str, List[str], Phoneset],
                 args: Tuple[str, ...] = ("-ps",)):
        self.binary_path = binary_path
        self.args = list(args)
        self._phone_set = phoneset if isinstance(phoneset, Phoneset) else Phoneset(phoneset)

    def available(self) -> bool:
        return shutil.which(self.binary_path) is not None

    def command(self, text: str) -> List[str]:
        return [self.binary_path] + self.args + [text, "none"]

    def convert_to_phoneme(self, text: str) -> Tuple[List[int], str]:
        result = subprocess.run(self.command(text), stdout=subprocess.PIPE, check=True)
        phone_txt = result.stdout.decode("utf-8", "strict")
        phone_list = phone_txt.split(" ")
        if phone_list and phone_list[-1] == "\n":
            phone_list = phone_list[:-1]
        phone_list = phone_list[1:-1]  # strip leading/trailing pau
        phone_ids = [self._phone_set.phone_to_id(p) for p in phone_list]
        return phone_ids, " ".join(phone_list)


def clean_phone_string(phonestring: str) -> str:
    """Strip empties and the lead/tail pau tokens from a flite ``-ps`` dump.

    Parity with reference: utils/tfrecord.py:51-59 (``write_phones``).
    """
    phones = [p for p in phonestring.split(" ") if p not in ("", "\n", " ")][1:-1]
    return " ".join(phones)
