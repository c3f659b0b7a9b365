"""Build the committed Porter stemmer golden, ``porter_stems.json``: each
word with its stem in NLTK's default mode (``NLTK_EXTENSIONS``) and in
Porter's published algorithm (``ORIGINAL_ALGORITHM``), as NLTK's
``PorterStemmer`` gives them.

The words: every word of ``retr_qa_cot.txt`` as it is written there, the
test forms of each suffix rule of Porter's paper and of NLTK's extensions,
and NLTK's pool of irregular forms. Run with NLTK installed:

    python tests/fixtures/make_porter_fixture.py

``tests/test_torch_porter.py`` holds the golden equal to NLTK and the
port's stemmer equal to the golden; ``chip_smoke.py`` checks the port's
stemmer against it where NLTK is absent.
"""

import json
import re
from pathlib import Path

from nltk.stem import PorterStemmer

HERE = Path(__file__).parent

# the examples beside each rule of steps 1a-5b in Porter (1980), then forms
# that reach NLTK's extra rules (-ies/-ied of four letters, y after a lone
# consonant, alli first, bli, fulli, logi, two-letter cvc)
RULE_FORMS = """
caresses ponies ties caress cats feed agreed plastered bled motoring sing
conflated troubled sized hopping tanned falling hissing fizzed failing filing
happy sky relational conditional rational valenci hesitanci digitizer
conformabli radicalli differentli vileli analogousli vietnamization
predication operator feudalism decisiveness hopefulness callousness formaliti
sensitiviti sensibiliti triplicate formative formalize electriciti electrical
hopeful goodness revival allowance inference airliner gyroscopic adjustable
defensible irritant replacement adjustment dependent adoption homologou
communism activate angulariti homologous effective bowdlerize probate rate
cease controll roll
flies dies lies spied died tied cried enjoy spy fly try by my generalli
finalli fulli hopefulli beautifulli sensibli possibli geologi theologi
archaeologi philologi owed axed boxing seeing agreement yelling yyyy toy
syzygy trees ivy troubles private oaten orrery tr ee tree y
""".split()


def main() -> None:
    words = list(dict.fromkeys(re.findall(r"\w+", (HERE / "retr_qa_cot.txt").read_text())))
    nltk_mode = PorterStemmer()
    words += [w for w in RULE_FORMS if w not in words]
    words += [w for w in sorted(nltk_mode.pool) if w not in words]
    original = PorterStemmer(mode=PorterStemmer.ORIGINAL_ALGORITHM)
    comment = ("word -> [stem in NLTK's default mode, stem in Porter's original algorithm]; "
               "written by make_porter_fixture.py")
    # one word a line
    lines = [f"{json.dumps(w, ensure_ascii=False)}: "
             f"{json.dumps([nltk_mode.stem(w), original.stem(w)], ensure_ascii=False)}"
             for w in words]
    text = f'{{"_comment": {json.dumps(comment)},\n"stems": {{\n' + ",\n".join(lines) + "\n}}\n"
    json.loads(text)
    (HERE / "porter_stems.json").write_text(text)
    print(f"wrote {len(words)} words")


if __name__ == "__main__":
    main()
