"""Region-aware phone number parsing and validation (counterpart of
``transmogrifai_tpu/ops/phone.py``).

Reference: core/.../impl/feature/PhoneNumberParser.scala:1-566 — four
transformers (ParsePhoneNumber, ParsePhoneDefaultCountry, IsValidPhoneNumber,
IsValidPhoneDefaultCountry, plus the PhoneMap variant) backed by Google's
libphonenumber.  That library is a JVM dependency; here the subset the
reference exercises is reimplemented natively:

- region metadata: country calling code, valid national-number lengths, trunk
  prefix, and (for NANPA) leading-digit constraints, for 50+ regions;
- international format: a ``+`` prefix switches to calling-code extraction by
  longest prefix match (the reference's ``InternationalCode`` region);
- region resolution (``validCountryCode``): explicit region code when
  recognized, else fuzzy country-name match by Jaccard similarity over
  character bigrams, else the default region;
- strict vs lenient validation: lenient truncates a too-long number from the
  right before checking (phoneUtil.truncateTooLongNumber);
- parse returns the normalized ``+{calling code}{national number}`` or None.

All logic is host string work, as in the reference: it never reaches the
device.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from ..data.dataset import Column
from ..stages.base import BinaryTransformer, Param, UnaryTransformer
from ..types import Binary, BinaryMap, Phone, PhoneMap, Text

INTERNATIONAL_CODE = "ZZ"  # libphonenumber convention: unknown region

#: region -> (calling code, valid national-number lengths, trunk prefix,
#:            national-number regex or None)
#: Lengths follow libphonenumber's general descriptions (possible lengths).
REGION_METADATA: Dict[str, Tuple[str, frozenset, str, Optional[str]]] = {
    # NANPA: 10 digits, area code and exchange both [2-9]XX (trunk '1')
    **{r: ("1", frozenset({10}), "1", r"^[2-9]\d{2}[2-9]\d{6}$")
       for r in ("US", "CA", "PR", "DO", "BS", "BB", "JM", "TT", "GU", "VI")},
    "GB": ("44", frozenset({7, 9, 10}), "0", None),
    "IE": ("353", frozenset({7, 8, 9}), "0", None),
    "FR": ("33", frozenset({9}), "0", None),
    "DE": ("49", frozenset(range(6, 12)), "0", None),
    "IT": ("39", frozenset(range(6, 12)), "", None),  # Italy keeps leading 0
    "ES": ("34", frozenset({9}), "", None),
    "PT": ("351", frozenset({9}), "", None),
    "NL": ("31", frozenset({9}), "0", None),
    "BE": ("32", frozenset({8, 9}), "0", None),
    "CH": ("41", frozenset({9}), "0", None),
    "AT": ("43", frozenset(range(6, 14)), "0", None),
    "SE": ("46", frozenset(range(7, 11)), "0", None),
    "NO": ("47", frozenset({8}), "", None),
    "DK": ("45", frozenset({8}), "", None),
    "FI": ("358", frozenset(range(5, 13)), "0", None),
    "PL": ("48", frozenset({9}), "", None),
    "CZ": ("420", frozenset({9}), "", None),
    "HU": ("36", frozenset({8, 9}), "06", None),
    "RO": ("40", frozenset({9}), "0", None),
    "GR": ("30", frozenset({10}), "", None),
    "TR": ("90", frozenset({10}), "0", None),
    "RU": ("7", frozenset({10}), "8", None),
    "UA": ("380", frozenset({9}), "0", None),
    "IL": ("972", frozenset({8, 9}), "0", None),
    "SA": ("966", frozenset({8, 9}), "0", None),
    "AE": ("971", frozenset({8, 9}), "0", None),
    "EG": ("20", frozenset({8, 9, 10}), "0", None),
    "ZA": ("27", frozenset({9}), "0", None),
    "NG": ("234", frozenset({7, 8, 10}), "0", None),
    "KE": ("254", frozenset({9, 10}), "0", None),
    "GH": ("233", frozenset({9}), "0", None),
    "MA": ("212", frozenset({9}), "0", None),
    "JP": ("81", frozenset({9, 10}), "0", None),
    "CN": ("86", frozenset({10, 11}), "0", None),
    "KR": ("82", frozenset(range(8, 12)), "0", None),
    "IN": ("91", frozenset({10}), "0", None),
    "SG": ("65", frozenset({8}), "", None),
    "HK": ("852", frozenset({8}), "", None),
    "TW": ("886", frozenset({8, 9}), "0", None),
    "TH": ("66", frozenset({8, 9}), "0", None),
    "MY": ("60", frozenset({8, 9, 10}), "0", None),
    "ID": ("62", frozenset(range(8, 13)), "0", None),
    "PH": ("63", frozenset({8, 9, 10}), "0", None),
    "VN": ("84", frozenset({9, 10}), "0", None),
    "AU": ("61", frozenset({9}), "0", None),
    "NZ": ("64", frozenset({8, 9, 10}), "0", None),
    "BR": ("55", frozenset({10, 11}), "0", None),
    "MX": ("52", frozenset({10}), "01", None),
    "AR": ("54", frozenset({10}), "0", None),
    "CL": ("56", frozenset({9}), "", None),
    "CO": ("57", frozenset({10}), "0", None),
    "PE": ("51", frozenset({9}), "0", None),
}

#: region code -> country name(s) (comma-separated alternates) for the fuzzy
#: resolution path (reference DefaultCountryCodes, PhoneNumberParser.scala:326+)
COUNTRY_NAMES: Dict[str, str] = {
    "US": "USA, United States of America", "CA": "Canada",
    "DO": "Dominican Republic", "PR": "Puerto Rico", "BS": "Bahamas",
    "BB": "Barbados", "JM": "Jamaica", "TT": "Trinidad & Tobago",
    "GB": "United Kingdom, Great Britain", "IE": "Ireland", "FR": "France",
    "DE": "Germany, Deutschland", "IT": "Italy, Italia", "ES": "Spain",
    "PT": "Portugal", "NL": "Netherlands, Holland", "BE": "Belgium",
    "CH": "Switzerland", "AT": "Austria", "SE": "Sweden", "NO": "Norway",
    "DK": "Denmark", "FI": "Finland", "PL": "Poland", "CZ": "Czech Republic,"
    " Czechia", "HU": "Hungary", "RO": "Romania", "GR": "Greece",
    "TR": "Turkey", "RU": "Russia, Russian Federation", "UA": "Ukraine",
    "IL": "Israel", "SA": "Saudi Arabia", "AE": "United Arab Emirates",
    "EG": "Egypt", "ZA": "South Africa", "NG": "Nigeria", "KE": "Kenya",
    "GH": "Ghana", "MA": "Morocco", "JP": "Japan", "CN": "China",
    "KR": "South Korea, Korea", "IN": "India", "SG": "Singapore",
    "HK": "Hong Kong", "TW": "Taiwan", "TH": "Thailand", "MY": "Malaysia",
    "ID": "Indonesia", "PH": "Philippines", "VN": "Vietnam",
    "AU": "Australia", "NZ": "New Zealand", "BR": "Brazil, Brasil",
    "MX": "Mexico", "AR": "Argentina", "CL": "Chile", "CO": "Colombia",
    "PE": "Peru",
}

#: calling code -> regions sharing it (international-format validation tries
#: every region on the code)
_BY_CALLING_CODE: Dict[str, List[str]] = {}
for _r, (_cc, _, _, _) in REGION_METADATA.items():
    _BY_CALLING_CODE.setdefault(_cc, []).append(_r)

_MAX_CC_LEN = max(len(c) for c in _BY_CALLING_CODE)


def supported_regions() -> List[str]:
    return sorted(REGION_METADATA)


def clean_number(pn: str) -> str:
    """Trim and drop every char except digits and '+' (reference cleanNumber)."""
    return re.sub(r"[^+\d]", "", pn.strip())


def _bigrams(s: str) -> set:
    s = s.strip().upper()
    return {s[i:i + 2] for i in range(len(s) - 1)} or {s}


def _jaccard(a: set, b: set) -> float:
    if not a or not b:
        return 0.0
    return len(a & b) / len(a | b)


def resolve_region(phone: Optional[str], region_code: Optional[str],
                   default_region: str = "US",
                   region_codes: Optional[List[str]] = None,
                   country_names: Optional[List[str]] = None) -> str:
    """The reference's validCountryCode resolution order
    (PhoneNumberParser.scala:285-305): international format wins, then an
    exact region-code match, then the closest country name by bigram Jaccard
    similarity, then the default region."""
    if phone and clean_number(phone).startswith("+"):
        return INTERNATIONAL_CODE
    if region_code:
        rc = region_code.strip().upper()
        codes = [c.upper() for c in (region_codes or list(COUNTRY_NAMES))]
        if rc in codes or rc in REGION_METADATA:
            return rc
        names = country_names or [COUNTRY_NAMES.get(c, c) for c in codes]
        if codes:
            rc_bi = _bigrams(rc if len(rc) > 1 else region_code.strip())
            best, best_sim = None, -1.0
            for code, name in zip(codes, names):
                for alt in str(name).split(","):
                    sim = _jaccard(rc_bi, _bigrams(alt))
                    if sim > best_sim:
                        best, best_sim = code, sim
            if best is not None:
                return best
    return default_region


def _national_valid(national: str, region: str) -> bool:
    _, lengths, _, pattern = REGION_METADATA[region]
    if len(national) not in lengths:
        return False
    if pattern is not None and not re.match(pattern, national):
        return False
    return True


def _strip_trunk(digits: str, region: str) -> str:
    trunk = REGION_METADATA[region][2]
    if trunk and digits.startswith(trunk) and len(digits) > len(trunk):
        return digits[len(trunk):]
    return digits


def _truncate_to_valid(national: str, region: str) -> str:
    """Lenient mode: drop digits from the right until the length is possible
    (phoneUtil.truncateTooLongNumber)."""
    lengths = REGION_METADATA[region][1]
    max_len = max(lengths)
    while len(national) > max_len:
        national = national[:-1]
    return national


def parse_phone(value: Optional[str], region: str = "US",
                strict: bool = False) -> Optional[str]:
    """Normalized ``+{cc}{national}`` when valid, else None (reference parse).

    ``region`` may be ``ZZ`` (international): the calling code then comes from
    the number itself, which must start with '+'.
    """
    if value is None:
        return None
    if len(value) < 2:
        return None
    digits = clean_number(value)
    if digits.startswith("+") or region == INTERNATIONAL_CODE:
        body = digits.lstrip("+")
        # longest-prefix calling-code match
        for k in range(min(_MAX_CC_LEN, len(body)), 0, -1):
            cc = body[:k]
            regions = _BY_CALLING_CODE.get(cc)
            if not regions:
                continue
            national = body[k:]
            for r in regions:
                cand = national if strict else _truncate_to_valid(national, r)
                if _national_valid(cand, r):
                    return f"+{cc}{cand}"
            return None  # calling code recognized, national number invalid
        return None
    if region not in REGION_METADATA:
        return None
    national = _strip_trunk(digits, region)
    if not strict:
        national = _truncate_to_valid(national, region)
    if _national_valid(national, region):
        return f"+{REGION_METADATA[region][0]}{national}"
    return None


def validate_phone(value: Optional[str], region: str = "US",
                   strict: bool = False) -> Optional[bool]:
    """True/False validity; None for a missing value (reference validate)."""
    if value is None:
        return None
    if len(value) < 2:
        return False
    return parse_phone(value, region, strict) is not None


# ---------------------------------------------------------------------------
# Stages (PhoneNumberParser.scala:144-255)
# ---------------------------------------------------------------------------

class _PhoneParamsMixin:
    strict_validation = Param(
        default=False,
        doc="validate the number exactly as presented; lenient mode truncates "
            "a too-long number before checking")
    default_region = Param(default="US")


class ParsePhoneDefaultCountry(_PhoneParamsMixin, UnaryTransformer):
    """Phone -> normalized Phone using the default region (parsePhoneNoCC)."""

    input_types = (Phone,)
    output_type = Phone

    def transform_columns(self, cols: List[Column], dataset) -> Column:
        return Column.from_values(
            Phone, [parse_phone(v, self.default_region, self.strict_validation)
                    for v in cols[0].data])

    def transform_values(self, values):
        return parse_phone(values[0], self.default_region, self.strict_validation)


class IsValidPhoneDefaultCountry(_PhoneParamsMixin, UnaryTransformer):
    """Phone -> Binary validity using the default region (validatePhoneNoCC)."""

    input_types = (Phone,)
    output_type = Binary

    def transform_columns(self, cols: List[Column], dataset) -> Column:
        return Column.from_values(
            Binary,
            [validate_phone(v, self.default_region, self.strict_validation)
             for v in cols[0].data])

    def transform_values(self, values):
        return validate_phone(values[0], self.default_region,
                              self.strict_validation)


class _PhoneCountryMixin(_PhoneParamsMixin):
    region_codes = Param(default=None, doc="recognized region codes")
    country_names = Param(default=None,
                          doc="country names aligned with region_codes")

    def _region_for(self, phone, rc):
        # pass country_names through unmodified: resolve_region derives the
        # names aligned with region_codes when None, so defaulting here would
        # pair custom codes with the wrong default names
        return resolve_region(
            phone, rc, self.default_region,
            self.region_codes, self.country_names)


class ParsePhoneNumber(_PhoneCountryMixin, BinaryTransformer):
    """(Phone, region-or-country Text) -> normalized Phone (parsePhone)."""

    input_types = (Phone, Text)
    output_type = Phone

    def transform_columns(self, cols: List[Column], dataset) -> Column:
        out = [parse_phone(p, self._region_for(p, rc), self.strict_validation)
               for p, rc in zip(cols[0].data, cols[1].data)]
        return Column.from_values(Phone, out)

    def transform_values(self, values):
        p, rc = values
        return parse_phone(p, self._region_for(p, rc), self.strict_validation)


class IsValidPhoneNumber(_PhoneCountryMixin, BinaryTransformer):
    """(Phone, region-or-country Text) -> Binary validity (validatePhone)."""

    input_types = (Phone, Text)
    output_type = Binary

    def transform_columns(self, cols: List[Column], dataset) -> Column:
        out = [validate_phone(p, self._region_for(p, rc),
                              self.strict_validation)
               for p, rc in zip(cols[0].data, cols[1].data)]
        return Column.from_values(Binary, out)

    def transform_values(self, values):
        p, rc = values
        return validate_phone(p, self._region_for(p, rc),
                              self.strict_validation)


class IsValidPhoneMapDefaultCountry(_PhoneParamsMixin, UnaryTransformer):
    """PhoneMap -> BinaryMap validity per key (validatePhoneMapNoCC)."""

    input_types = (PhoneMap,)
    output_type = BinaryMap

    def transform_columns(self, cols: List[Column], dataset) -> Column:
        region, strict = self.default_region, self.strict_validation
        out = []
        for m in cols[0].data:
            if m is None:
                out.append({})
                continue
            entries = {k: validate_phone(v, region, strict)
                       for k, v in m.items()}
            out.append({k: b for k, b in entries.items() if b is not None})
        return Column.from_values(BinaryMap, out)

    def transform_values(self, values):
        m = values[0] or {}
        entries = {k: validate_phone(v, self.default_region,
                                     self.strict_validation)
                   for k, v in m.items()}
        return {k: b for k, b in entries.items() if b is not None}
