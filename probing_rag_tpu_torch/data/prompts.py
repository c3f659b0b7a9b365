"""Prompt template library — exact-render parity with the reference.

Copy of ``probing_rag_tpu/data/prompts.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_data_eval.py``
holds the two equal.

Behavioral spec: the reference's prompts.py. The few-shot exemplars are data,
not code: the reference's published EM/F1 numbers (BASELINE.md) depend on the
byte-exact prompt strings (including trailing spaces and the 4-paragraph
structure the answer extractor keys on — utils.py:396-420), so the exemplar
text is preserved verbatim while the templates are rebuilt as structured
records + renderers.

Conventions that downstream code relies on:
- ``cot_prompt`` produces exactly 4 ``\\n\\n``-separated exemplar paragraphs
  followed by the live question block, so a completed generation splits into
  5 paragraphs; the decode loop's paragraph stop (exp_rag.py:190-193) and the
  answer extractor's ``split('\\n\\n')[4]`` both key on that.
- ``format_evidences`` renders ``passage {i}: {text}`` lines (exp_rag.py:369-379).
"""

from __future__ import annotations

import re as _re

from dataclasses import dataclass
from typing import List, Sequence


@dataclass(frozen=True)
class CotExemplar:
    lead: str  # "Question" or "Query" — the reference mixes both
    question: str
    rationale: str
    answer: str

    def render(self) -> str:
        return (
            f"{self.lead}: {self.question}\n"
            f"Rationale: {self.rationale}\n"
            f"Answer: {self.answer}"
        )


# 4-shot CoT exemplars for the no-retrieval prompt (prompts.py:61-80).
COT_EXEMPLARS: List[CotExemplar] = [
    CotExemplar(
        "Question",
        "2014 S/S is the debut album of a South Korean boy group that was formed by who?",
        "Evidence 2 identifies 2014 S/S as the debut album of the South Korean group WINNER "
        "and states that it was released by YG Entertainment. This directly connects the "
        "group WINNER with YG Entertainment.",
        "WINNER",
    ),
    CotExemplar(
        "Question",
        "Roger O. Egeberg was Assistant Secretary for Health and Scientific Affairs during "
        "the administration of a president that served during what years?",
        "Roger O. Egeberg served in this role during the Nixon administration. It also "
        "specifies other roles he held, but the key information is his service under "
        "President Nixon. To determine the years, we need to know the timeframe of Nixon's "
        "presidency.",
        "1969 to 1974",
    ),
    CotExemplar(
        "Question",
        "Are Giuseppe Verdi and Ambroise Thomas both Opera composers ?",
        "Ambroise Thomas (1811-1896) is a French opera composer, listing his complete "
        "operas. Giuseppe Verdi (1813-1901) was an Italian opera composer, detailing his "
        "work and lifespan.",
        "Yes",
    ),
    CotExemplar(
        "Question",
        "Which writer was from England, Henry Roth or Robert Erskine Childers?",
        "Henry Roth was an American novelist, best known for his novel Call It Sleep "
        "(1934). He was born in Austria-Hungary (now Ukraine) and emigrated to the United "
        "States as a child. Robert Erskine Childers was an English-born writer and Irish "
        "nationalist. He was born in London, England, in 1870 and is best known for his "
        "novel The Riddle of the Sands (1903). Childers later became involved in Irish "
        "politics and was a prominent figure in the Irish independence movement.",
        "Robert Erskine ",  # trailing space is in the reference
    ),
]

# 3+1-shot exemplars for the with-retrieval prompt (prompts.py:93-115). The
# first three use the "Query" lead, the last one "Question" — kept as-is.
RETR_COT_EXEMPLARS: List[CotExemplar] = [
    CotExemplar(
        "Query",
        "Who was the first President of the United States?",
        "The United States was formed after gaining independence from Britain. The first "
        "President would have been elected soon after the formation of the country. George "
        "Washington is commonly known as the leader of the American Revolution and the "
        "first President.",
        "George Washington",
    ),
    CotExemplar(
        "Query",
        "Who wrote the play 'Romeo and Juliet'?",
        "“Romeo and Juliet” is a famous play, a tragedy involving two young "
        "lovers. The play is widely associated with English literature from the "
        "Renaissance period. William Shakespeare is the most renowned playwright of the "
        "English Renaissance and is known for his tragedies.",
        "William Shakespeare",
    ),
    CotExemplar(
        "Query",
        "What is the main ingredient in traditional Italian pesto sauce?",
        "Pesto is a famous Italian sauce typically used in pasta dishes. Traditional "
        "pesto originates from the Liguria region, specifically Genoa. The primary "
        "ingredients include basil, olive oil, garlic, pine nuts, and Parmesan cheese. "
        "The main flavoring herb that distinguishes pesto is basil.",
        "Basil",
    ),
    COT_EXEMPLARS[3],
]


@dataclass(frozen=True)
class RetrDemo:
    """One full retr_qa_cot demo: question + 5 passages + rationale + answer.
    ``passages_lead`` keeps the reference's per-demo trailing-space quirk
    ("Passages: " in demo 1, "Passages:" in demos 2-4, prompts.py:117-167)."""

    question: str
    passages_lead: str
    passages: List[str]
    rationale: str
    answer: str

    def render(self) -> str:
        passage_block = "\n".join(
            f"passage {i + 1}: {p}" for i, p in enumerate(self.passages)
        )
        return (
            f"Question: \n{self.question}\n{self.passages_lead}\n"
            f"{passage_block}\nRationale: {self.rationale}\nAnswer: {self.answer}"
        )
# Full 5-passage CoT demos (prompts.py:117-167) — unused by the reference's
# main path but part of the template library; exemplars verbatim (data).
RETR_QA_COT_DEMOS: List[RetrDemo] = [
    RetrDemo(
        question='2014 S/S is the debut album of a South Korean boy group that was formed by who?',
        passages_lead='Passages: ',
        passages=[
            'S (에스) is a South Korean project group consisting of three members: Kangta, Lee Ji-hoon and Shin Hye-sung. The group debuted in 2003, under the SM Entertainment label. After 11 years, they released and promoted another mini-album in 2014.',
            "2014 S/S is the debut album of South Korean group WINNER. It was released on August 12, 2014 by the group's record label, YG Entertainment. The members were credited for writing the lyrics and composing the majority of the album's songs.",
            'The discography of South Korean girl group S.E.S. consists of seven studio albums, four compilation albums, three video albums, and one remix album. The group debuted in 1997 under SM Entertainment and disbanded in 2002. The group then made their comeback in 2016.',
            'The Wonder Years is the debut studio album by South Korean girl group Wonder Girls. It was released on September 13, 2007, by JYP Entertainment.',
            'Girls\' Generation is the debut Japanese album by South Korean Girls\' Generation, released by Nayutawave Records and Universal Music Japan on June 1, 2011. A repackaged edition of the album, "The Boys", was released on December 28, 2011.',
        ],
        rationale='Evidence 2 identifies 2014 S/S as the debut album of the South Korean group WINNER and states that it was released by YG Entertainment. This directly connects the group WINNER with YG Entertainment.',
        answer='WINNER',
    ),
    RetrDemo(
        question='Roger O. Egeberg was Assistant Secretary for Health and Scientific Affairs during the administration of a president that served during what years?',
        passages_lead='Passages:',
        passages=[
            "Roger Olaf Egeberg, M.D. (13 November 1902 - 13 September 1997 Washington, D.C.) was an American medical educator, administrator and advocate of public health. He was General Douglas MacArthur's personal physician during World War II in the Pacific theater. His other roles included Assistant Secretary for Health and Scientific Affairs in the Department of Health, Education, and Welfare (now the United States Department of Health and Human Services) during the Nixon administration and Dean of the University of Southern California's medical school.",
            'Charles Edwin Johnson served as Acting United States Secretary of Health and Human Services from January to April 2009 during the Obama presidency. Johnson was appointed by then President George W. Bush in 2005 as Assistant Secretary for Budget, Technology, and Finance. He was a public accountant for 31 years prior to joining the department.',
            'United States Secretary of Health and Human Services',
            'United States Deputy Secretary of Health and Human Services',
            'Roger M. Natsuhara was the acting United States Assistant Secretary of the Navy (Installations and Environment).',
        ],
        rationale='Roger O. Egeberg served in this role during the Nixon administration. It also specifies other roles he held, but the key information is his service under President Nixon. To determine the years, we need to know the timeframe of Nixon’s presidency.',
        answer='1969 to 1974',
    ),
    RetrDemo(
        question='Are Giuseppe Verdi and Ambroise Thomas both Opera composers ?',
        passages_lead='Passages:',
        passages=[
            'This is a list of the complete operas of the French opera composer Ambroise Thomas (1811-1896). All premieres took place in Paris unless otherwise noted.',
            'Verdi refers to Giuseppe Verdi (1813-1901), Italian opera composer.',
            'The following is a list of published compositions by the composer Giuseppe Verdi (1813-1901).',
            'Giuseppe Fortunino Francesco Verdi (] ; 9 or 10 October 1813 - 27 January 1901) was an Italian opera composer.',
            'This is an incomplete list of authors who have written libretti for operas. Only librettists with their own articles in Wikipedia are listed. The name of the composer of each opera is also given.',
        ],
        rationale='Ambroise Thomas (1811-1896) is a French opera composer, listing his complete operas. Giuseppe Verdi (1813-1901) was an Italian opera composer, detailing his work and lifespan.',
        answer='Yes',
    ),
    RetrDemo(
        question='Which writer was from England, Henry Roth or Robert Erskine Childers?',
        passages_lead='Passages:',
        passages=[
            'Henry Roth was a writer.',
            'Henry Roth (February 8, 1906 - October 13, 1995) was an American novelist and short story writer.',
            'This is a list of novelists from England.',
            'Philip Milton Roth (born March 19, 1933) is an American novelist.',
            'Henry Melville was an Australian writer.',
        ],
        rationale='Henry Roth was an American novelist, best known for his novel Call It Sleep (1934). He was born in Austria-Hungary (now Ukraine) and emigrated to the United States as a child. Robert Erskine Childers was an English-born writer and Irish nationalist. He was born in London, England, in 1870 and is best known for his novel The Riddle of the Sands (1903). Childers later became involved in Irish politics and was a prominent figure in the Irish independence movement.',
        answer='Robert Erskine ',
    ),
]


def cot_prompt(query: str) -> str:
    """4-shot CoT prompt, no documents (prompts.py:61-80)."""
    shots = "\n\n".join(e.render() for e in COT_EXEMPLARS)
    return f"{shots}\n\nQuestion: {query}\nRationale:"


def retr_qa_cot2(query: str, docs: str) -> str:
    """CoT prompt with a retrieved-passages block (prompts.py:93-115)."""
    shots = "\n\n".join(e.render() for e in RETR_COT_EXEMPLARS)
    return f"{shots}\n\nPassages: \n{docs}\nQuestion: \n{query}\nRationale:"


def retr_qa_cot(query: str, docs: str) -> str:
    """Full 5-passage-demo CoT prompt (prompts.py:117-167) — present for
    template-library completeness; the reference's main path uses
    ``retr_qa_cot2``."""
    shots = "\n\n".join(d.render() for d in RETR_QA_COT_DEMOS)
    return f"{shots}\n\nQuestion: \n{query}\nPassages: \n{docs}\nRationale:"


def format_evidences(passages: Sequence[str]) -> str:
    """Render retrieved passages as the ``passage i:`` block
    (return_evidences, exp_rag.py:369-379).

    DELIBERATE DIVERGENCE from the reference: paragraph breaks inside a
    passage are collapsed to single newlines. The reference's decode stop
    re-splits the FULL decoded text on "\\n\\n" every token and halts when
    the count moves off 5 (exp_rag.py:190-193) — a retrieved passage that
    itself contains "\\n\\n" makes it stop after the FIRST generated token,
    producing an empty answer. The on-device stop here only triggers on a
    NEW paragraph break (models/decode.py), so we sanitize evidence text to
    keep prompt paragraph counts stable instead of reproducing the
    degenerate immediate-stop (tests/test_prompts.py pins this)."""
    return "\n".join(
        "passage %d: %s" % (i + 1, _re.sub("\n{2,}", "\n", p))
        for i, p in enumerate(passages)
    )


def inst_prompt(q: str) -> str:
    """Plain instruction prompt (prompts.py:30-37)."""
    return (
        "Instruction: Answer the following question. Just answer in 5 words or less. "
        "Don't generate any additional comments, just write your answer.\n\n"
        f"Question: \n{q}\n\nAnswer:"
    )


_ICL_SHOTS = [
    ("What is the capital of France?", "Paris"),
    ('Who wrote the play "Romeo and Juliet"?', "William Shakespeare"),
    ("Which planet is known as the Red Planet?", "Mars"),
    ("What is the largest ocean on Earth?", "Pacific Ocean"),
    ("Who painted the Mona Lisa?", "Leonardo da Vinci"),
]


def icl_prompt(q: str) -> str:
    """5-shot short-answer ICL prompt (prompts.py:5-29)."""
    blocks = [
        f"Example {i + 1}:\nQuestion: {question}\nAnswer: {answer}"
        for i, (question, answer) in enumerate(_ICL_SHOTS)
    ]
    blocks.append(f"Example {len(_ICL_SHOTS) + 1}:\nQuestion: {q}\nAnswer:")
    return "\n\n".join(blocks)


def retr_qa(query: str, docs: str) -> str:
    """Non-CoT retrieval QA prompt (prompts.py:82-91)."""
    return (
        "[INST]Instruction: Write an Answer to the Query based on the Query and "
        "Evidence. Just answer in 5 words or less. Don't generate any additional "
        "comments, just write your answer.[/INST]\n"
        f"Question: \n{query}\n\nPassages: \n{docs}\n\nAnswer:"
    )


def dummy_prompt(query: str) -> str:
    return query


def flare_query_reformulation_prompt(query: str, masked_text: str) -> str:
    """FLARE implicit-query reformulation prompt (prompts.py:172-180)."""
    return (
        "User input: Generate a summary about Joe Biden\n"
        "Generated output so far: Joe Biden attended ____, where he earned a law degree.\n"
        "Given the above passage, ask a question to which the answer is the "
        "term/entity/phrase: What university did Joe Biden attend?\n\n"
        f"User input: {query}\n"
        f"Generated output so far: {masked_text}\n"
        "Given the above passage, ask a question to which the answer is the "
        "term/entity/phrase:"
    )


def flare_for_new_sent_prompt(y_t: str, evidences: str) -> str:
    """FLARE regenerate-sentence prompt (prompts.py:182-194)."""
    return (
        "low confidence sentence: Joe Biden attended the University of Pennsylvania, "
        "where he earned a law degree\n"
        "passage 1: Joe Biden attended the University of Delaware, where he graduated "
        "in 1965 with a Bachelor of Arts in history and political science.\n"
        "passage 2: After completing his undergraduate degree, Biden attended Syracuse "
        "University College of Law, where he earned a law degree in 1968.\n"
        "passage 3: Joe Biden began his political career shortly after law school, "
        "becoming one of the youngest senators in U.S. history when he was elected to "
        "the Senate in 1972.\n"
        "passage 4: Throughout his long political career, Biden served as the Vice "
        "President of the United States from 2009 to 2017 under President Barack Obama, "
        "and later became the 46th President of the United States in 2021.\n"
        "passage 5: Biden's time at Syracuse University was marked by a plagiarism "
        "controversy, but he eventually graduated and went on to start his political "
        "career.\n"
        "new sentence: He graduated from the University of Delaware in 1965 with a "
        "Bachelor of Arts in history and political science.\n\n"
        f"low confidence sentence: {y_t}\n"
        f"{evidences}\n"
        "new sentence:"
    )


_CLF_SHOTS = [
    ("Riverdance is part of a traditional dance from origination from which country?", 1),
    ("Sir Harry Donald Secombe appeared notably as Mr Buble in a 1968 British musical drama film directed by who?", 0),
    ("What did the population of Russians do between 1926-1959?", 0),
    ("Which former mentor joined the judges' panel this season?", 1),
]


def llm_based_clf_prompt(q: str) -> str:
    """LLM-as-classifier baseline prompt (prompts.py:196-212)."""
    head = (
        "Instruction: If you can answer the question, print 1. If you can't answer, "
        "print 0. Don't generate additional answers."
    )
    blocks = [head + f"\nQuestion: {_CLF_SHOTS[0][0]}\nAnswer: {_CLF_SHOTS[0][1]}"]
    blocks += [f"Question: {q_}\nAnswer: {a}" for q_, a in _CLF_SHOTS[1:]]
    blocks.append(f"Question: {q}\nAnswer:")
    return "\n\n".join(blocks)
