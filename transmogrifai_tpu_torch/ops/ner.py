"""Named-entity recognition: sentence splitting + per-language tagging
(counterpart of ``transmogrifai_tpu/ops/ner.py``).

The role of TransmogrifAI's NameEntityRecognizer (Text -> MultiPickListMap
of token -> set of entity types, tagged per sentence and folded), with
OpenNLPSentenceSplitter and OpenNLPNameEntityTagger behind it.  The learned
tagger (``ops/ner_model.py``) runs for en, es and nl from the weights this
package ships; the deterministic rule + gazetteer tagger below is the other
backend, and the one taken when a language's artifact is absent.  Host
string work: strings never reach the device.  Entity types match the
reference's NameEntityType enum: Date, Location, Money, Organization,
Percentage, Person, Time, Misc.
"""

from __future__ import annotations

import re
from typing import Dict, List, Set

import numpy as np

from ..data.dataset import Column
from ..stages.base import Param, UnaryTransformer
from ..types import MultiPickListMap, Text
from ..utils.text import split_sentences

# NameEntityType enum values (utils/.../text/NameEntityTagger.scala:78-86)
DATE = "Date"
LOCATION = "Location"
MONEY = "Money"
ORGANIZATION = "Organization"
PERCENTAGE = "Percentage"
PERSON = "Person"
TIME = "Time"
MISC = "Misc"

_HONORIFICS = frozenset({
    "mr", "mr.", "mrs", "mrs.", "ms", "ms.", "dr", "dr.", "prof", "prof.",
    "sir", "madam", "miss", "rev", "rev.", "capt", "capt.", "sgt", "sgt.",
})

_FIRST_NAMES = frozenset({
    "james", "john", "robert", "michael", "william", "david", "richard",
    "joseph", "thomas", "charles", "mary", "patricia", "jennifer", "linda",
    "elizabeth", "barbara", "susan", "jessica", "sarah", "karen", "nancy",
    "lisa", "margaret", "betty", "sandra", "ashley", "emily", "donna",
    "anna", "kimberly", "carol", "michelle", "amanda", "dorothy", "melissa",
    "deborah", "stephanie", "rebecca", "sharon", "laura", "cynthia", "kathleen",
    "amy", "angela", "shirley", "brenda", "emma", "pamela", "nicole", "helen",
    "daniel", "matthew", "anthony", "mark", "donald", "steven", "paul",
    "andrew", "joshua", "kenneth", "kevin", "brian", "george", "timothy",
    "ronald", "edward", "jason", "jeffrey", "ryan", "jacob", "gary",
    "nicholas", "eric", "jonathan", "stephen", "larry", "justin", "scott",
    "brandon", "benjamin", "samuel", "gregory", "alexander", "patrick",
    "frank", "raymond", "jack", "dennis", "jerry", "tyler", "aaron", "jose",
    "adam", "nathan", "henry", "peter", "zachary", "douglas", "harold",
})

_COUNTRIES = frozenset({
    "afghanistan", "argentina", "australia", "austria", "belgium", "brazil",
    "canada", "chile", "china", "colombia", "cuba", "denmark", "egypt",
    "england", "ethiopia", "finland", "france", "germany", "greece", "india",
    "indonesia", "iran", "iraq", "ireland", "israel", "italy", "japan",
    "kenya", "mexico", "netherlands", "nigeria", "norway", "pakistan",
    "peru", "philippines", "poland", "portugal", "russia", "scotland",
    "spain", "sweden", "switzerland", "thailand", "turkey", "ukraine",
    "usa", "venezuela", "vietnam", "wales",
})

_CITIES = frozenset({
    "amsterdam", "atlanta", "austin", "baltimore", "barcelona", "beijing",
    "berlin", "boston", "cairo", "chicago", "dallas", "delhi", "denver",
    "detroit", "dubai", "dublin", "houston", "istanbul", "jakarta", "lagos",
    "london", "madrid", "miami", "moscow", "mumbai", "munich", "nairobi",
    "paris", "philadelphia", "phoenix", "rome", "seattle", "seoul",
    "shanghai", "singapore", "sydney", "tokyo", "toronto", "vienna",
})

_STATES = frozenset({
    "alabama", "alaska", "arizona", "arkansas", "california", "colorado",
    "connecticut", "delaware", "florida", "georgia", "hawaii", "idaho",
    "illinois", "indiana", "iowa", "kansas", "kentucky", "louisiana",
    "maine", "maryland", "massachusetts", "michigan", "minnesota",
    "mississippi", "missouri", "montana", "nebraska", "nevada", "ohio",
    "oklahoma", "oregon", "pennsylvania", "tennessee", "texas", "utah",
    "vermont", "virginia", "washington", "wisconsin", "wyoming",
})

_ORG_SUFFIXES = frozenset({
    "inc", "inc.", "corp", "corp.", "ltd", "ltd.", "llc", "co", "co.",
    "company", "corporation", "university", "institute", "foundation",
    "bank", "group", "association", "committee", "agency", "ministry",
})

_MONTHS = frozenset({
    "january", "february", "march", "april", "may", "june", "july",
    "august", "september", "october", "november", "december",
    "jan", "feb", "mar", "apr", "jun", "jul", "aug", "sep", "sept",
    "oct", "nov", "dec",
})

_WEEKDAYS = frozenset({
    "monday", "tuesday", "wednesday", "thursday", "friday", "saturday",
    "sunday",
})

_MONEY_RE = re.compile(r"^[$€£¥]\d[\d,]*(?:\.\d+)?[kmb]?$", re.IGNORECASE)
_PERCENT_RE = re.compile(r"^\d[\d,]*(?:\.\d+)?%$")
_TIME_RE = re.compile(r"^\d{1,2}:\d{2}(?::\d{2})?(?:am|pm)?$", re.IGNORECASE)
_AMPM_RE = re.compile(r"^\d{1,2}(?:am|pm)$", re.IGNORECASE)
_ISO_DATE_RE = re.compile(r"^\d{4}-\d{2}-\d{2}$")
_SLASH_DATE_RE = re.compile(r"^\d{1,2}/\d{1,2}/\d{2,4}$")
_YEAR_RE = re.compile(r"^(19|20)\d{2}$")

# Tokenizer for tagging: keeps case, currency/percent glyphs, and number shapes.
_NER_TOKEN_RE = re.compile(
    r"[$€£¥]\d[\d,]*(?:\.\d+)?[kMBkmb]?"   # money
    r"|\d[\d,]*(?:\.\d+)?%"                # percentage
    r"|\d{4}-\d{2}-\d{2}"                  # ISO date
    r"|\d{1,2}/\d{1,2}/\d{2,4}"            # slash date
    r"|\d{1,2}:\d{2}(?::\d{2})?(?:[aApP][mM])?"  # time
    r"|\d+(?:[aApP][mM])?"                 # plain number / 5pm
    r"|[^\W\d_]+(?:[.'][^\W\d_]+)*"        # words incl. inner-dot abbreviations
)


def ner_tokenize(sentence: str) -> List[str]:
    """Case-preserving tokenizer for entity tagging."""
    return _NER_TOKEN_RE.findall(sentence or "")


def _is_capitalized(tok: str) -> bool:
    """Proper-noun shape: leading uppercase (covers Xxxx, McDonald, O'Brien, IBM)."""
    return bool(tok) and tok[0].isupper()


class RuleNameEntityTagger:
    """Deterministic rule + gazetteer tagger (OpenNLPNameEntityTagger role).

    ``tag(sentence)`` returns token -> set of entity-type names for one sentence.
    """

    def tag(self, sentence: str) -> Dict[str, Set[str]]:
        toks = ner_tokenize(sentence)
        tags: Dict[str, Set[str]] = {}

        def add(tok: str, ent: str) -> None:
            tags.setdefault(tok, set()).add(ent)

        person_run = False
        org_window: List[str] = []
        for i, tok in enumerate(toks):
            low = tok.lower()
            if _MONEY_RE.match(tok):
                add(tok, MONEY)
                person_run = False
                continue
            if _PERCENT_RE.match(tok):
                add(tok, PERCENTAGE)
                person_run = False
                continue
            if _TIME_RE.match(tok) or _AMPM_RE.match(tok):
                add(tok, TIME)
                person_run = False
                continue
            if (_ISO_DATE_RE.match(tok) or _SLASH_DATE_RE.match(tok)
                    or low in _MONTHS or low in _WEEKDAYS):
                add(tok, DATE)
                person_run = False
                continue
            if _YEAR_RE.match(tok):
                prev = toks[i - 1].lower() if i else ""
                if prev in _MONTHS or prev in {"in", "since", "of", "year"}:
                    add(tok, DATE)
                person_run = False
                continue
            if low in _HONORIFICS:
                person_run = True
                org_window = []
                continue
            if _is_capitalized(tok):
                if low in _COUNTRIES or low in _CITIES or low in _STATES:
                    add(tok, LOCATION)
                    person_run = False
                    org_window = []
                    continue
                if low.rstrip(".") in _ORG_SUFFIXES:
                    for prev_tok in org_window:
                        add(prev_tok, ORGANIZATION)
                    add(tok, ORGANIZATION)
                    person_run = False
                    org_window = []
                    continue
                if person_run or low in _FIRST_NAMES:
                    add(tok, PERSON)
                    person_run = True
                    org_window = org_window + [tok]
                    continue
                org_window = org_window + [tok]
                if i == 0:
                    continue  # sentence-initial capitalization is ambiguous
                add(tok, MISC)
                continue
            person_run = False
            org_window = []
        return tags


def _tagger_languages():
    from .ner_lang import TAGGER_LANGUAGES

    return TAGGER_LANGUAGES


class NameEntityRecognizer(UnaryTransformer):
    """Text -> MultiPickListMap of token -> entity types (NameEntityRecognizer.scala).

    Splits into sentences, tags each, and folds the per-sentence maps by union —
    mirroring the reference's sentence-wise tagging + foldLeft merge.

    Two tagger backends (the reference's OpenNLPNameEntityTagger role):
    - ``"learned"`` (default): a shipped averaged-perceptron model
      (ops/ner_model.py, the package's artifacts) —
      generalizes to unseen names via shape/context features;
    - ``"rules"``: the deterministic rule + gazetteer tagger above.
    Falls back to rules if the learned artifact is absent.

    ``language`` selects the per-language model the way the reference's
    OpenNLPModels maps (language, entity) -> binary artifact
    (OpenNLPModels.scala:48-70 ships en + es + nl NER): ``"auto"``
    (default) detects per input text and dispatches to the es/nl taggers
    when their artifacts are present, else English; an explicit code pins
    the tagger.
    """

    input_types = (Text,)
    output_type = MultiPickListMap

    tagger = Param(default="learned",
                   validator=lambda v: v in ("learned", "rules"))
    language = Param(
        default="auto",
        validator=lambda v: v == "auto" or v in _tagger_languages())

    def _tagger_for(self, language: str):
        """Sentence tagger for one language (None = no learned artifact)."""
        if self.tagger == "learned":
            from .ner_model import load_pretrained

            learned = load_pretrained(language=language)
            if learned is not None:
                return lambda sent: learned.tag_to_entities(
                    ner_tokenize(sent))
            if language != "en":  # missing per-language artifact -> English
                return self._tagger_for("en")
        rules = RuleNameEntityTagger()
        return rules.tag

    def _resolve_language(self, text: str) -> str:
        """Detected language when it has a shipped tagger, else English."""
        if self.language != "auto":
            return str(self.language)
        from .ner_lang import TAGGER_LANGUAGES

        from ..utils.lang import detect_language

        lang = detect_language(text)
        return lang if lang in TAGGER_LANGUAGES else "en"

    def _tag_text(self, text: str, taggers: Dict[str, object]
                  ) -> Dict[str, Set[str]]:
        lang = self._resolve_language(text or "")
        tag = taggers.get(lang)
        if tag is None:
            tag = taggers[lang] = self._tagger_for(lang)
        merged: Dict[str, Set[str]] = {}
        # per-language abbreviation sets: the reference's per-language
        # OpenNLP sentence models play the same role
        for sent in split_sentences(text or "", language=lang):
            for tok, ents in tag(sent).items():
                merged.setdefault(tok, set()).update(ents)
        return merged

    def transform_columns(self, cols: List[Column], dataset) -> Column:
        taggers: Dict[str, object] = {}
        out = np.empty(len(cols[0]), dtype=object)
        for i, text in enumerate(cols[0].data):
            out[i] = {k: sorted(v)
                      for k, v in self._tag_text(text, taggers).items()}
        return Column(MultiPickListMap, out)

    def transform_values(self, values):
        return {k: sorted(v)
                for k, v in self._tag_text(values[0], {}).items()}
