"""Per-language NER dictionaries (counterpart of
``transmogrifai_tpu/ops/ner_lang.py``): the gazetteer side of the per-language
taggers, as the reference's OpenNLPModels loads Spanish and Dutch NER models
beside English.

Only the lexical layer is per-language: the tagger (hashed averaged
perceptron, ``ops/ner_model.py``) and its orthographic and shape features are
language-neutral.  English keeps its dictionaries in ``ops/ner.py``: the
shipped en artifact's feature space depends on them.
"""

from __future__ import annotations

from typing import Dict, FrozenSet

#: language -> {dict feature tag -> member set (lowercase)}
LANG_DICTS: Dict[str, Dict[str, FrozenSet[str]]] = {
    "es": {
        "month": frozenset(
            "enero febrero marzo abril mayo junio julio agosto septiembre "
            "octubre noviembre diciembre".split()),
        "weekday": frozenset(
            "lunes martes miércoles jueves viernes sábado domingo".split()),
        # dotted forms only: ner_tokenize strips periods, so these stay
        # INERT as dict features — the perceptron learns honorifics through
        # its lexical prev=/w= features instead (measured: letting
        # dict=honorific fire in training collapsed real-prose precision,
        # the model over-trusted gazetteer hits; es F1 0.78 -> 0.58)
        "honorific": frozenset(
            "sr. sra. srta. dr. dra. don doña señor "
            "señora profesor profesora inspector inspectora".split()),
        "orgsuf": frozenset(
            "s.a. s.l. sociedad compañía grupo banco".split()),
        "city": frozenset(
            "madrid barcelona valencia sevilla bilbao zaragoza málaga "
            "granada murcia alicante córdoba valladolid "
            "lima bogotá quito caracas santiago montevideo asunción "
            "méxico guadalajara monterrey habana".split()),
        "country": frozenset(
            "españa méxico argentina colombia chile perú uruguay paraguay "
            "bolivia ecuador venezuela cuba francia alemania italia "
            "portugal brasil japón china rusia marruecos".split()),
        "firstname": frozenset(
            "maría josé antonio carmen manuel ana luis laura carlos marta "
            "javier elena miguel lucía pedro sofía diego valentina pablo "
            "camila andrés isabel fernando teresa rafael".split()),
        "role": frozenset(
            "presidente presidenta director directora ministro ministra "
            "alcalde alcaldesa juez jueza portavoz gerente".split()),
    },
    "nl": {
        "month": frozenset(
            "januari februari maart april mei juni juli augustus september "
            "oktober november december".split()),
        "weekday": frozenset(
            "maandag dinsdag woensdag donderdag vrijdag zaterdag "
            "zondag".split()),
        "honorific": frozenset(
            "dhr. mevr. dr. prof. ir. drs. meneer mevrouw heer professor "
            "inspecteur rechercheur".split()),
        "orgsuf": frozenset(
            "b.v. n.v. holding groep bank maatschappij".split()),
        "city": frozenset(
            "amsterdam rotterdam utrecht eindhoven groningen tilburg "
            "almere breda nijmegen arnhem haarlem enschede maastricht "
            "leiden delft zwolle antwerpen gent brugge leuven".split()),
        "country": frozenset(
            "nederland belgië duitsland frankrijk spanje italië portugal "
            "engeland zweden noorwegen denemarken polen japan china "
            "rusland suriname marokko turkije".split()),
        "firstname": frozenset(
            "jan piet kees willem hendrik johannes maria anna johanna "
            "elisabeth cornelis sanne daan emma lucas julia lars lieke "
            "bram fleur sven noor thijs roos joris femke".split()),
        "role": frozenset(
            "directeur directrice voorzitter minister burgemeester "
            "rechter woordvoerder manager wethouder".split()),
    },
}

#: languages with a trainable per-language tagger (dispatch inventory);
#: English is implicit (the default artifact)
TAGGER_LANGUAGES = ("en",) + tuple(sorted(LANG_DICTS))


def dictionary_feats(low: str, language: str) -> list:
    """Per-language gazetteer-membership features (same feature names as
    the English path so per-language weight artifacts stay drop-in)."""
    d = LANG_DICTS.get(language)
    if d is None:
        return []
    return [f"dict={tag}" for tag, members in d.items() if low in members]
