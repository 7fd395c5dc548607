"""Domain-value parsers: phone, email, URL, MIME type (counterpart of
``transmogrifai_tpu/ops/domains.py``).

Reference: core/.../feature/PhoneNumberParser.scala:1-566 (libphonenumber validity by
region), ValidEmailTransformer.scala, EmailToPickListMapTransformer, URL handling in
dsl/RichTextFeature.scala, MimeTypeDetector.scala (Tika magic-byte sniffing for Base64).

All host-side string analysis; outputs are Binary/PickList columns that vectorize
downstream.  Phone validity delegates to the region-metadata engine in
``ops/phone.py`` (calling codes, per-region length tables, NANPA patterns,
trunk prefixes — the full four-transformer surface lives there).
"""

from __future__ import annotations

import base64
import binascii
import re
from typing import List, Optional

from ..data.dataset import Column
from ..stages.base import Param, UnaryTransformer
from ..types import Base64 as B64Type
from ..types import Binary, Email, Phone, PickList, URL

_EMAIL_RE = re.compile(
    r"^[A-Za-z0-9.!#$%&'*+/=?^_`{|}~-]+@[A-Za-z0-9](?:[A-Za-z0-9-]{0,61}[A-Za-z0-9])?"
    r"(?:\.[A-Za-z0-9](?:[A-Za-z0-9-]{0,61}[A-Za-z0-9])?)+$")

_URL_RE = re.compile(
    r"^(?:(?P<scheme>https?|ftp)://)"
    r"(?P<host>[A-Za-z0-9](?:[A-Za-z0-9.-]*[A-Za-z0-9])?)"
    r"(?::\d{1,5})?(?:[/?#].*)?$", re.IGNORECASE)


def parse_phone(value: Optional[str], default_region: str = "US",
                strict: bool = False) -> Optional[bool]:
    """Validity of a phone number for the region (PhoneNumberParser.validate).

    Delegates to the region-metadata engine in ops/phone.py (calling codes,
    per-region length tables, NANPA digit patterns, trunk prefixes).
    """
    from .phone import validate_phone

    return validate_phone(value, default_region.upper(), strict)


def is_valid_email(value: Optional[str]) -> Optional[bool]:
    if not value:
        return None
    return _EMAIL_RE.match(value) is not None


def email_prefix(value: Optional[str]) -> Optional[str]:
    if not value or not is_valid_email(value):
        return None
    return value.split("@", 1)[0]


def email_domain(value: Optional[str]) -> Optional[str]:
    if not value or not is_valid_email(value):
        return None
    return value.split("@", 1)[1].lower()


def is_valid_url(value: Optional[str]) -> Optional[bool]:
    if not value:
        return None
    m = _URL_RE.match(value)
    return m is not None and "." in m.group("host")


def url_domain(value: Optional[str]) -> Optional[str]:
    if not value:
        return None
    m = _URL_RE.match(value)
    if m is None or "." not in m.group("host"):
        return None
    return m.group("host").lower()


def url_protocol(value: Optional[str]) -> Optional[str]:
    """Scheme of a valid URL (reference RichTextFeature.toProtocol)."""
    if not value:
        return None
    m = _URL_RE.match(value)
    if m is None or "." not in m.group("host"):
        return None
    return m.group("scheme").lower()


# (offset, magic bytes, mime) — Tika-style magic table
# (MimeTypeDetector.scala wraps Tika's magic-byte database; this is the
# same mechanism with the ~55 signatures that cover Tika's common set:
# images, audio, video, archives, documents, fonts, executables, data)
_MAGIC = [
    # --- images ---
    (0, b"\x89PNG\r\n\x1a\n", "image/png"),
    (0, b"\xff\xd8\xff", "image/jpeg"),
    (0, b"GIF87a", "image/gif"),
    (0, b"GIF89a", "image/gif"),
    (0, b"BM", "image/bmp"),
    (0, b"II*\x00", "image/tiff"),
    (0, b"MM\x00*", "image/tiff"),
    (0, b"\x00\x00\x01\x00", "image/vnd.microsoft.icon"),
    (0, b"8BPS", "image/vnd.adobe.photoshop"),
    # --- audio ---
    (0, b"OggS", "audio/ogg"),
    (0, b"ID3", "audio/mpeg"),
    (0, b"\xff\xfb", "audio/mpeg"),
    (0, b"\xff\xf3", "audio/mpeg"),
    (0, b"fLaC", "audio/x-flac"),
    (0, b"MThd", "audio/midi"),
    (0, b"#!AMR", "audio/amr"),
    # --- video ---
    (0, b"\x1aE\xdf\xa3", "video/x-matroska"),  # also webm
    (0, b"FLV\x01", "video/x-flv"),
    (0, b"\x00\x00\x01\xba", "video/mpeg"),
    (0, b"\x00\x00\x01\xb3", "video/mpeg"),
    (0, b"0&\xb2u\x8ef\xcf\x11", "video/x-ms-asf"),
    # --- archives / compression ---
    (0, b"\x1f\x8b", "application/gzip"),
    (0, b"BZh", "application/x-bzip2"),
    (0, b"\xfd7zXZ\x00", "application/x-xz"),
    (0, b"7z\xbc\xaf\x27\x1c", "application/x-7z-compressed"),
    (0, b"Rar!\x1a\x07", "application/x-rar-compressed"),
    (0, b"\x28\xb5\x2f\xfd", "application/zstd"),
    (0, b"MSCF", "application/vnd.ms-cab-compressed"),
    (0, b"\x04\x22\x4d\x18", "application/x-lz4"),
    (257, b"ustar", "application/x-tar"),
    # --- documents ---
    (0, b"%PDF", "application/pdf"),
    (0, b"%!PS", "application/postscript"),
    (0, b"{\\rtf", "application/rtf"),
    # --- fonts ---
    (0, b"\x00\x01\x00\x00\x00", "font/ttf"),
    (0, b"OTTO", "font/otf"),
    (0, b"wOFF", "font/woff"),
    (0, b"wOF2", "font/woff2"),
    # --- executables / bytecode ---
    (0, b"\x7fELF", "application/x-executable"),
    (0, b"MZ", "application/x-msdownload"),
    (0, b"\xca\xfe\xba\xbe", "application/java-vm"),
    (0, b"\x00asm", "application/wasm"),
    (0, b"\xfe\xed\xfa\xce", "application/x-mach-binary"),
    (0, b"\xfe\xed\xfa\xcf", "application/x-mach-binary"),
    (0, b"\xcf\xfa\xed\xfe", "application/x-mach-binary"),
    # --- data formats ---
    (0, b"SQLite format 3\x00", "application/x-sqlite3"),
    (0, b"PAR1", "application/x-parquet"),
    (0, b"Obj\x01", "application/avro"),  # Avro object container
]

#: mp4-family brands inside the ftyp box at offset 8
_FTYP_BRANDS = [
    (b"M4A", "audio/mp4"),
    (b"qt", "video/quicktime"),
    (b"3gp", "video/3gpp"),
    (b"heic", "image/heic"),
    (b"heix", "image/heic"),
    (b"avif", "image/avif"),
    (b"mif1", "image/heif"),
]

#: OOXML package roots -> document type (matched against PARSED zip entry
#: names, never raw substrings — a zip containing "crossword/clues.txt"
#: must stay application/zip)
_OOXML_ROOTS = [
    (b"word/",
     "application/vnd.openxmlformats-officedocument.wordprocessingml.document"),
    (b"xl/",
     "application/vnd.openxmlformats-officedocument.spreadsheetml.sheet"),
    (b"ppt/",
     "application/vnd.openxmlformats-officedocument.presentationml.presentation"),
]

#: ODF/epub "mimetype" entry literals (stored first and uncompressed per
#: spec, so the content sits right after the local header in the window)
_MIMETYPE_LITERALS = [
    (b"application/epub+zip", "application/epub+zip"),
    (b"application/vnd.oasis.opendocument.text",
     "application/vnd.oasis.opendocument.text"),
    (b"application/vnd.oasis.opendocument.spreadsheet",
     "application/vnd.oasis.opendocument.spreadsheet"),
    (b"application/vnd.oasis.opendocument.presentation",
     "application/vnd.oasis.opendocument.presentation"),
]


def _zip_container_type(head: bytes) -> str:
    """Walk the local-file-header records visible in the sniff window and
    classify the package by its ENTRY NAMES (Tika reads the zip directory;
    the names in the local headers are the same information)."""
    pos = 0
    while True:
        pos = head.find(b"PK\x03\x04", pos)
        if pos < 0 or pos + 30 > len(head):
            return "application/zip"
        name_len = int.from_bytes(head[pos + 26:pos + 28], "little")
        extra_len = int.from_bytes(head[pos + 28:pos + 30], "little")
        name = head[pos + 30:pos + 30 + name_len]
        if name == b"mimetype":
            content_at = pos + 30 + name_len + extra_len
            content = head[content_at:content_at + 80]
            for literal, mime in _MIMETYPE_LITERALS:
                if content.startswith(literal):
                    return mime
        for root, mime in _OOXML_ROOTS:
            if name.startswith(root):
                return mime
        pos += 4

_SNIFF_B64_CHARS = 10920  # multiple of 4 -> decodes to 8190 bytes


def _sniff(head: bytes) -> str:
    """MIME from leading bytes (Tika magic semantics)."""
    for off, magic, mime in _MAGIC:
        if head[off:off + len(magic)] == magic:
            return mime
    if head.startswith(b"RIFF") and len(head) >= 12:
        sub = head[8:12]
        if sub == b"WEBP":
            return "image/webp"
        if sub == b"WAVE":
            return "audio/wav"
        if sub == b"AVI ":
            return "video/x-msvideo"
        return "application/octet-stream"
    if len(head) >= 12 and head[4:8] == b"ftyp":
        brand = head[8:12]
        for b, mime in _FTYP_BRANDS:
            if brand.startswith(b):
                return mime
        return "video/mp4"  # isom / mp41 / mp42 / generic brands
    if head.startswith(b"PK\x03\x04"):
        return _zip_container_type(head)
    if head.startswith(b"\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1"):
        # OLE2 compound file: legacy Office family (Tika refines via the
        # directory; the container type is the stable answer)
        return "application/x-ole-storage"
    if head.startswith(b"#!"):
        return "text/x-shellscript"
    stripped = head.lstrip()
    low = stripped[:256].lower()
    if low.startswith(b"<?xml"):
        return "image/svg+xml" if b"<svg" in head.lower() else "application/xml"
    if low.startswith(b"<svg"):
        return "image/svg+xml"
    if low.startswith((b"<html", b"<!doctype html")):
        return "text/html"
    if stripped.startswith((b"{", b"[")):
        return "application/json"
    try:
        head.decode("utf-8")
        return "text/plain"
    except UnicodeDecodeError:
        return "application/octet-stream"


def detect_mime_type(b64_value: Optional[str]) -> Optional[str]:
    """Magic-byte MIME sniffing of base64 content (MimeTypeDetector/Tika
    capability, MimeTypeDetector.scala): ~55 signatures incl. offset magics,
    RIFF/ftyp sub-typing, and OOXML/ODF/epub discrimination by parsed zip
    entry names."""
    if not b64_value:
        return None
    try:
        head = base64.b64decode(b64_value[:_SNIFF_B64_CHARS], validate=True)
    except (binascii.Error, ValueError):
        return None
    if not head:
        return None
    return _sniff(head)


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------

class _UnaryValueTransformer(UnaryTransformer):
    """Common shell: apply a module-level parse fn over one text-like column."""

    _fn = None  # override

    def transform_columns(self, cols: List[Column], dataset) -> Column:
        fn = type(self)._fn
        return Column.from_values(self.output_type,
                                  [fn(v) for v in cols[0].data])


class PhoneNumberValidator(_UnaryValueTransformer):
    """Phone -> Binary validity (IsValidPhoneDefaultCountry capability; the
    full four-transformer surface lives in ops/phone.py)."""

    input_types = (Phone,)
    output_type = Binary

    default_region = Param(default="US")
    strict_validation = Param(default=False)

    def transform_columns(self, cols: List[Column], dataset) -> Column:
        region, strict = self.default_region, self.strict_validation
        return Column.from_values(
            Binary, [parse_phone(v, region, strict) for v in cols[0].data])


class ValidEmailTransformer(_UnaryValueTransformer):
    input_types = (Email,)
    output_type = Binary
    _fn = staticmethod(is_valid_email)


class EmailToPickList(_UnaryValueTransformer):
    """Email -> domain PickList (EmailToPickListMapTransformer capability)."""

    input_types = (Email,)
    output_type = PickList
    _fn = staticmethod(email_domain)


class ValidUrlTransformer(_UnaryValueTransformer):
    input_types = (URL,)
    output_type = Binary
    _fn = staticmethod(is_valid_url)


class UrlToDomainTransformer(_UnaryValueTransformer):
    input_types = (URL,)
    output_type = PickList
    _fn = staticmethod(url_domain)


class MimeTypeDetector(_UnaryValueTransformer):
    input_types = (B64Type,)
    output_type = PickList
    _fn = staticmethod(detect_mime_type)
