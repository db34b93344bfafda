"""Entity data collection from Wikidata/Wikimedia Commons
(parity meerqat/data/wiki.py).

Offline-deterministic logic (thumbnail URL construction, license scoring,
image heuristics, class filtering, stats) is implemented directly. The
live update pipeline — Wikidata SPARQL entity attributes, Commons SPARQL
depictions, the Commons REST category/image walk, superclass and
feminine-label queries — is implemented end-to-end with an injectable
``session`` so the parsing/merging/cap semantics are fully testable
offline (tests/test_wiki_live.py drives them through fake sessions);
only the actual HTTP egress is environment-gated. :func:`request`
retries with backoff and raises a clear error when the host has no
egress — this framework's runtime has none, so the builders are meant
for data-prep hosts.
"""
from __future__ import annotations

import json
import re
import time
import warnings
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set

from viquae_torch.data.utils import md5

QID_URI_PREFIX = "http://www.wikidata.org/entity/"
HUMAN = QID_URI_PREFIX + "Q5"
VALID_DATE_TYPE = "http://www.w3.org/2001/XMLSchema#dateTime"
UPLOAD_URI_PREFIX = "https://upload.wikimedia.org/wikipedia/commons/"
SPECIAL_FILE_PATH_URI_PREFIX = "http://commons.wikimedia.org/wiki/Special:FilePath/"
SPECIAL_PATH_URI_PREFIX = "https://commons.wikimedia.org/wiki/Special:FilePath/"
WIKIDATA_ENDPOINT = "https://query.wikidata.org/sparql"
COMMONS_SPARQL_ENDPOINT = "https://commons-query.wikimedia.org/sparql"
# the Wikidata query service grants one client 60s of compute per 60s
# window (reference wiki.py:164); used as the 429 cool-down
WIKIDATA_COMPUTE_LIMIT = 60

VALID_ENCODING = {"png", "jpg", "jpeg", "gif", "svg", "tiff", "tif", "pdf",
                  "djvu", "webp", "xcf", "bmp"}
VALID_IMAGE_HEURISTICS = {"categories", "description", "depictions", "title"}

# thumbnails of special formats get converted (prefix, suffix per extension)
EXTENSIONS_PRE_AND_SUFFIXES = {
    "svg": ("", ".png"),
    "tif": ("lossy-page1-", ".jpg"),
    "tiff": ("lossy-page1-", ".jpg"),
    "pdf": ("page1-", ".jpg"),
    "djvu": ("page1-", ".jpg"),
}

# license preference scores; higher is freer (0 = missing/other)
LICENSES = {
    "CC0": 8,
    "PUBLIC DOMAIN MARK": 7,
    "PUBLIC DOMAIN": 7,
    "PDM": 7,
    "BY": 6,
    "BY-SA": 5,
    "BY-NC": 4,
    "BY-ND": 3,
    "BY-NC-SA": 2,
    "BY-NC-ND": 1,
}

# entity image attributes in order of preference for the reference image
# (reference wiki.py:265)
RESERVED_IMAGES = ["image", "logo", "flag", "coat_of_arms", "service_ribbon"]
# SPARQL result keys that may bind several values per entity (stored as
# {value: binding} dicts) vs at most one (stored as the raw binding) —
# reference wiki.py:266-267
MULTIPLE_KEYS = {"instanceof", "occupation"}.union(RESERVED_IMAGES)
UNIQUE_KEYS = {"entityLabel", "gender", "genderLabel", "commons", "freebase",
               "date_of_birth", "date_of_death", "taxon_rank",
               "taxon_rankLabel"}

# Wikidata attribute query: all entity attributes the KB build consumes,
# one OPTIONAL block per property, image-valued properties decoded and
# underscored so they can key Commons files directly
# (parity reference wiki.py:204-239; %s = space-separated 'wd:Q…' values).
_IMAGE_PROPS = {"image": "P18", "flag": "P41", "coat_of_arms": "P94",
                "logo": "P154", "service_ribbon": "P2425"}
_PLAIN_PROPS = {"commons": "P373", "gender": "P21", "occupation": "P106",
                "freebase": "P646", "date_of_birth": "P569",
                "date_of_death": "P570", "taxon_rank": "P105"}
WIKIDATA_QUERY = (
    "SELECT ?entity ?entityLabel ?instanceof ?instanceofLabel "
    + " ".join(f"?{name}" for name in _IMAGE_PROPS)
    + " " + " ".join(f"?{name}" for name in _PLAIN_PROPS)
    + " ?occupationLabel ?genderLabel ?taxon_rankLabel\n"
    "{\n"
    "  VALUES ?entity { %s }\n"
    "  ?entity wdt:P31 ?instanceof .\n"
    + "".join(
        f"  OPTIONAL {{ ?entity wdt:{prop} ?_{name} .\n"
        f"    BIND(replace(wikibase:decodeUri(STR(?_{name})),\" \",\"_\")"
        f" AS ?{name}) }}\n"
        for name, prop in _IMAGE_PROPS.items())
    + "".join(f"  OPTIONAL {{ ?entity wdt:{prop} ?{name} . }}\n"
              for name, prop in _PLAIN_PROPS.items())
    + "  SERVICE wikibase:label "
    "{ bd:serviceParam wikibase:language \"en\". }\n}"
)

# feminine ("female form of label", P2521) labels of classes/occupations
# (parity reference wiki.py:240-252)
WIKIDATA_FEMININE_QUERY = (
    "SELECT ?entity ?entity_female_label\n{\n"
    "  VALUES ?entity { %s }\n"
    "  ?entity wdt:P2521 ?entity_female_label .\n"
    "  FILTER(LANG(?entity_female_label) = \"en\").\n}"
)

# superclasses (P279) of a class list; second %s is the property path,
# e.g. 'wdt:P279+' for the full closure (parity reference wiki.py:253-261)
WIKIDATA_SUPERCLASSES_QUERY = (
    "SELECT ?class ?classLabel ?subclassof ?subclassofLabel\nWHERE\n{\n"
    "  VALUES ?class { %s }.\n"
    "  ?class %s ?subclassof.\n"
    "  SERVICE wikibase:label "
    "{ bd:serviceParam wikibase:language \"en\". }\n}"
)

# Commons structured-data query: images depicting (P180) the entities,
# restricted to PIL-decodable formats (parity reference wiki.py:271-282)
COMMONS_SPARQL_QUERY = (
    "SELECT ?depicted_entity ?commons_entity ?special_path ?url ?encoding "
    "WHERE {\n"
    "  VALUES ?depicted_entity { %s }\n"
    "  ?commons_entity wdt:P180 ?depicted_entity .\n"
    "  ?commons_entity schema:contentUrl ?url .\n"
    "  ?commons_entity schema:encodingFormat ?encoding .\n"
    "  VALUES ?encoding { \"image/png\" \"image/jpg\" \"image/jpeg\" "
    "\"image/tiff\" \"image/gif\" }\n"
    "  bind(iri(concat("
    "\"http://commons.wikimedia.org/wiki/Special:FilePath/\", "
    "wikibase:decodeUri(substr(str(?url),53)))) AS ?special_path)\n}"
)

# inverse direction: entities depicted in given Commons media entities
# (parity reference wiki.py:283-288; prefix is 'sdc:')
COMMONS_DEPICTED_ENTITIES_QUERY = (
    "SELECT ?commons_entity ?depicted_entity WHERE {\n"
    "  VALUES ?commons_entity { %s }\n"
    "  ?commons_entity wdt:P180 ?depicted_entity .\n}"
)

# Commons REST endpoints (parity reference wiki.py:296,303)
COMMONS_REST_LIST = (
    "https://commons.wikimedia.org/w/api.php?action=query"
    "&list=categorymembers&cmtitle={cmtitle}&cmprop=title|type&format=json"
    "&cmcontinue&cmlimit=max&cmtype={cmtype}"
)
COMMONS_REST_TITLE = (
    "https://commons.wikimedia.org/w/api.php?action=query&titles={titles}"
    "&prop=categories|description|imageinfo&format=json"
    "&iiprop=url|extmetadata&clshow=!hidden"
)


# --------------------------------------------------------------------------
# URL helpers
# --------------------------------------------------------------------------
def file_name_to_thumbnail(file_name: str, image_width: Optional[int] = None
                           ) -> str:
    """Commons file name -> upload.wikimedia.org (thumbnail) URL.

    Commons shards files by the md5 of the underscored name; thumbnails of
    special formats (svg/tif/pdf/djvu) get converted extensions.
    """
    file_name = file_name.replace(" ", "_")
    file_hash = md5(file_name)
    if image_width is None:
        thumb, sized_name = "", ""
    else:
        thumb = "thumb/"
        extension = file_name.split(".")[-1].lower()
        prefix, suffix = EXTENSIONS_PRE_AND_SUFFIXES.get(extension, ("", ""))
        sized_name = f"/{prefix}{image_width:d}px-{file_name}{suffix}"
    return (
        f"{UPLOAD_URI_PREFIX}{thumb}{file_hash[0]}/{file_hash[:2]}/"
        f"{file_name}{sized_name}"
    )


def thumbnail_to_file_name(url: str, original: bool = True) -> str:
    """Inverse of file_name_to_thumbnail (also handles Special:FilePath)."""
    for prefix in (SPECIAL_FILE_PATH_URI_PREFIX, SPECIAL_PATH_URI_PREFIX):
        if url.startswith(prefix):
            return url[len(prefix):]
    if url.startswith(UPLOAD_URI_PREFIX):
        rest = url[len(UPLOAD_URI_PREFIX):]
        if rest.startswith("thumb/"):
            parts = rest[len("thumb/a/a8/"):].split("/")
            return parts[0] if original else parts[-1]
        return rest[len("a/a8/"):]
    return url.split("/")[-1]


def special_path_to_file_name(special_path: str) -> str:
    return "File:" + special_path.split("/")[-1].replace("_", " ")


def uri_to_qid(uri: str) -> str:
    return uri.split("/")[-1]


def uris_to_qids(uris: Iterable[str]) -> Set[str]:
    return {uri_to_qid(uri) for uri in uris}


def bytes2dict(b: bytes) -> dict:
    return json.loads(b.decode("utf-8"))


# --------------------------------------------------------------------------
# license scoring
# --------------------------------------------------------------------------
def get_license(image: dict) -> str:
    return (
        image.get("extmetadata", {})
        .get("LicenseShortName", {})
        .get("value", "")
        .upper()
    )


def license_score(image: dict) -> int:
    license_ = get_license(image)
    cc = re.match(r"CC[ -](BY\S*)[ -]\d\.\d", license_)
    if cc is not None:
        license_ = cc.group(1)
    return LICENSES.get(license_, 0)


# --------------------------------------------------------------------------
# image heuristics (which image best illustrates the entity)
# --------------------------------------------------------------------------
def image_heuristic(entities: Dict[str, dict],
                    heuristics: Set[str] = VALID_IMAGE_HEURISTICS
                    ) -> Dict[str, dict]:
    """Score each candidate image of each entity by how many heuristics fire:
    label in all categories / in description / tagged as depiction / in
    title (parity wiki.py:740-796)."""
    invalid = set(heuristics) - VALID_IMAGE_HEURISTICS
    if invalid:
        raise NotImplementedError(
            f"No heuristic implemented for {invalid}; use {VALID_IMAGE_HEURISTICS}"
        )
    for entity in entities.values():
        label = entity.get("entityLabel", {}).get("value")
        if not label or "images" not in entity:
            continue
        label = label.lower()
        depictions = set()
        if "depictions" in heuristics:
            depictions = {
                special_path_to_file_name(d["special_path"]["value"])
                for d in entity.get("depictions", {}).values()
            }
        for title, image in entity["images"].items():
            image.setdefault("heuristics", {})
            if "categories" in heuristics and image.get("categories"):
                if all(label in c.lower() for c in image["categories"]):
                    image["heuristics"]["categories"] = True
            if "description" in heuristics:
                description = image.get("description", "")
                if isinstance(description, dict):
                    description = description.get("value")
                if description and label in description.lower():
                    image["heuristics"]["description"] = True
            if "depictions" in heuristics and title in depictions:
                image["heuristics"]["depictions"] = True
            if "title" in heuristics and label in title.lower():
                image["heuristics"]["title"] = True
    return entities


def best_image(entity: dict) -> Optional[str]:
    """Pick the image with most heuristics, ties by license score."""
    images = entity.get("images", {})
    if not images:
        return None
    return max(
        images,
        key=lambda t: (
            len(images[t].get("heuristics", {})),
            license_score(images[t]),
        ),
    )


def set_reference_images(entities: Dict[str, dict]) -> Dict[str, dict]:
    """Pick each entity's ``reference_image``: the first VALID_ENCODING
    URL among its image-valued attributes, tried in RESERVED_IMAGES
    preference order (illustrative image first, then logo/flag/...)
    (parity reference wiki.py:463-491)."""
    for entity in entities.values():
        found = False
        for key in RESERVED_IMAGES:
            attr = entity.get(key)
            if attr is None:
                continue
            # older single-valued harvests stored a raw binding here;
            # drop its scalar fields so only {value: binding} rows remain
            # (reference's 'type'/'value' pop hack, wiki.py:474-476)
            attr.pop("type", None)
            attr.pop("value", None)
            for binding in attr.values():
                url = (binding or {}).get("value")
                if not url:
                    continue
                if url.split(".")[-1].lower() in VALID_ENCODING:
                    entity["reference_image"] = url
                    found = True
                    break
            if found:
                break
    return entities


def keep_prominent_depictions(entities: Dict[str, dict]) -> Dict[str, dict]:
    """Keep only depictions :func:`depiction_instanceof_heuristic` marked
    prominent (parity reference wiki.py:551-560: the filter is
    unconditional — an entity whose depictions are all non-prominent ends
    up with none)."""
    for entity in entities.values():
        depictions = entity.get("depictions")
        if not depictions:
            continue
        entity["depictions"] = {
            mid: d for mid, d in depictions.items()
            if d.get("prominent_instanceof_heuristic", False)
        }
    return entities


def depiction_instanceof_heuristic(depictions: Dict[str, List[str]],
                                   entities: Dict[str, dict]
                                   ) -> Dict[str, dict]:
    """Mark each entity's depictions prominent unless the image also
    depicts ANOTHER entity of a shared ``instanceof`` class — a photo of
    two politicians is prominent for neither, a politician in front of a
    monument is prominent for both (parity reference wiki.py:525-550).

    ``depictions`` maps Commons media ids (Mxxx) to the URI list of every
    entity they depict (:func:`query_depicted_entities` output)."""
    for qid, entity in entities.items():
        instanceof = entity.get("instanceof")
        if not instanceof:
            continue
        classes = set(instanceof.keys())
        for mid_uri, depiction in entity.get("depictions", {}).items():
            mid = uri_to_qid(mid_uri)
            depiction["prominent_instanceof_heuristic"] = True
            for other_uri in depictions.get(mid, ()):
                other_qid = uri_to_qid(other_uri)
                if other_qid == qid:
                    continue
                other = entities.get(other_qid, {})
                if classes & set(other.get("instanceof", {}).keys()):
                    depiction["prominent_instanceof_heuristic"] = False
                    break
    return entities


# --------------------------------------------------------------------------
# class filtering
# --------------------------------------------------------------------------
def _entity_classes(entity) -> Set[str]:
    instanceof = entity.get("instanceof", {})
    if isinstance(instanceof, dict):
        return set(instanceof.keys())
    return set(instanceof or [])


def exclude_classes(entities: Dict[str, dict], classes_to_exclude: Set[str],
                    superclasses: Optional[Dict[str, Iterable[str]]] = None
                    ) -> Dict[str, dict]:
    superclasses = superclasses or {}
    out = {}
    for qid, entity in entities.items():
        classes = _entity_classes(entity)
        expanded = set(classes)
        for c in classes:
            expanded |= set(superclasses.get(c, ()))
        if expanded & set(classes_to_exclude):
            continue
        out[qid] = entity
    return out


def keep_classes(entities: Dict[str, dict], classes_to_keep: Set[str],
                 superclasses: Optional[Dict[str, Iterable[str]]] = None,
                 attributes_to_keep: Iterable[str] = ("gender", "occupation")
                 ) -> Dict[str, dict]:
    """Positive class filter. Like the reference (wiki.py:820-831), an
    entity with any non-empty attribute in ``attributes_to_keep``
    (gender P21 / occupation P106 by default — i.e. people) is kept
    regardless of its classes."""
    superclasses = superclasses or {}
    out = {}
    for qid, entity in entities.items():
        if any(entity.get(attr) for attr in attributes_to_keep):
            out[qid] = entity
            continue
        classes = _entity_classes(entity)
        expanded = set(classes)
        for c in classes:
            expanded |= set(superclasses.get(c, ()))
        if expanded & set(classes_to_keep):
            out[qid] = entity
    return out


def iso2year(iso: str) -> int:
    """ISO date -> year, handling negative (BC) years."""
    if iso.startswith("-"):
        return -int(iso[1:].split("-")[0])
    return int(iso.split("-")[0])


def remove_alive_humans(entities: Dict[str, dict],
                        year_threshold: float = float("inf")
                        ) -> Dict[str, dict]:
    """Keep only humans with a death date (or born before threshold)."""
    out = {}
    for qid, entity in entities.items():
        if "date_of_death" in entity:
            out[qid] = entity
            continue
        birth = entity.get("date_of_birth", {}).get("value")
        if birth and iso2year(birth) < year_threshold:
            out[qid] = entity
    return out


def stats(entities: Dict[str, dict]) -> Dict[str, int]:
    counts: Dict[str, int] = {"entities": len(entities)}
    for entity in entities.values():
        for key in entity:
            counts[key] = counts.get(key, 0) + 1
    return counts


def print_stats(entities: Dict[str, dict]) -> None:
    counts = stats(entities)
    width = max(len(k) for k in counts)
    for key in sorted(counts, key=counts.get, reverse=True):
        print(f"{key:<{width}}  {counts[key]}")


# --------------------------------------------------------------------------
# network layer (gated)
# --------------------------------------------------------------------------
def request(url: str, session=None, tries: int = 0, max_tries: int = 2,
            backoff: float = 2.0, **kwargs):
    """HTTP GET with retry/backoff (parity wiki.py:562-588). Raises
    RuntimeError with a clear message when the host has no egress."""
    import requests

    session = session or requests.Session()
    try:
        response = session.get(url, **kwargs)
        if response.status_code == 429 and tries < max_tries:
            # honor Retry-After like the reference (wiki.py:581-583); the
            # Wikidata query service grants 60s compute per 60s window, so
            # fall back to that cool-down when no header is sent
            retry_after = getattr(response, "headers", {}).get("Retry-After")
            # RFC 7231 allows Retry-After to be an HTTP-date, not just
            # delta-seconds; fall back to the Wikidata cool-down on non-ints
            try:
                delay = int(retry_after) if retry_after else WIKIDATA_COMPUTE_LIMIT
            except ValueError:
                delay = WIKIDATA_COMPUTE_LIMIT
            time.sleep(delay)
            return request(url, session, tries + 1, max_tries, backoff, **kwargs)
        if response.status_code in (500, 502, 503) and tries < max_tries:
            time.sleep(backoff ** (tries + 1))
            return request(url, session, tries + 1, max_tries, backoff, **kwargs)
        response.raise_for_status()
        return response
    except requests.exceptions.ConnectionError as e:
        if tries < max_tries:
            time.sleep(backoff ** (tries + 1))
            return request(url, session, tries + 1, max_tries, backoff, **kwargs)
        raise RuntimeError(
            f"Network unavailable for {url!r} — the wiki builders require an "
            "egress-enabled data-prep host"
        ) from e


def query_sparql_entities(query: str, endpoint: str, wikidata_ids,
                          prefix: str = "wd:", batch_size: int = 100,
                          session=None, skip_failed: bool = True) -> list:
    """Run a SPARQL query over batches of entity QIDs.

    With ``skip_failed`` (the default, matching the reference's
    warn-and-continue semantics at wiki.py:384-429 — a long harvest must
    survive a few poisoned batches), a batch that still fails after
    :func:`request`'s retries is skipped with a warning; otherwise the
    error propagates."""
    results = []
    ids = list(wikidata_ids)
    skipped = 0
    for start in range(0, len(ids), batch_size):
        batch = ids[start: start + batch_size]
        values = " ".join(prefix + q for q in batch)
        try:
            response = request(
                endpoint, session,
                params={"query": query % values, "format": "json"},
                headers={"User-Agent": "viquae-tpu/0.1"},
            )
        except Exception as e:  # noqa: BLE001 — harvest robustness
            if not skip_failed:
                raise
            warnings.warn(f"SPARQL batch failed ({e!r}); skipping "
                          f"{len(batch)} QIDs: {batch[:5]}…")
            skipped += len(batch)
            continue
        results.extend(
            response.json().get("results", {}).get("bindings", [])
        )
    if skipped:
        if skipped == len(ids) and ids:
            # every batch failed — this is not harvest robustness, it is a
            # dead endpoint / no-egress host; a silent empty result would let
            # callers overwrite entities.json with a no-op "success"
            raise RuntimeError(
                f"all {len(ids)} QIDs failed ({skipped} skipped in every "
                "batch) — endpoint unreachable or query rejected; refusing "
                "to return an empty harvest"
            )
        warnings.warn(f"skipped {skipped}/{len(ids)} QIDs in failed batches")
    return results


# --------------------------------------------------------------------------
# Wikidata updates
# --------------------------------------------------------------------------
def update_from_data(entities: Dict[str, dict], skip: Optional[str] = None,
                     session=None) -> Dict[str, dict]:
    """Merge WIKIDATA_QUERY results into ``entities``: UNIQUE_KEYS
    overwrite the attribute with the raw binding; MULTIPLE_KEYS accumulate
    ``{value: binding}`` dicts with the matching ``…Label`` binding stored
    under ``label`` (parity reference wiki.py:432-462).

    ``skip``: only query entities missing that attribute (resume seam)."""
    if skip is None:
        wikidata_ids = list(entities.keys())
    else:
        wikidata_ids = [qid for qid in entities if skip not in entities[qid]]
    results = query_sparql_entities(WIKIDATA_QUERY, WIKIDATA_ENDPOINT,
                                    wikidata_ids, session=session)
    for result in results:
        qid = uri_to_qid(result["entity"]["value"])
        entity = entities.get(qid)
        if entity is None:
            continue
        for key in UNIQUE_KEYS & result.keys():
            entity[key] = result[key]
        for key in MULTIPLE_KEYS & result.keys():
            entity.setdefault(key, {})
            binding = result[key]
            binding["label"] = result.get(key + "Label")
            entity[key][binding["value"]] = binding
    return entities


def update_from_commons_sparql(entities: Dict[str, dict], session=None
                               ) -> Dict[str, dict]:
    """Attach Commons images depicting each entity under ``depictions``
    (keyed by the Commons media-entity URI; parity reference
    wiki.py:492-511)."""
    results = query_sparql_entities(COMMONS_SPARQL_QUERY,
                                    COMMONS_SPARQL_ENDPOINT,
                                    list(entities.keys()), session=session)
    for result in results:
        qid = uri_to_qid(result["depicted_entity"]["value"])
        entity = entities.get(qid)
        if entity is None:
            continue
        mid_uri = result["commons_entity"]["value"]
        depiction = entity.setdefault("depictions", {}).setdefault(mid_uri, {})
        depiction["url"] = result["url"]
        depiction["special_path"] = result["special_path"]
    return entities


def query_depicted_entities(depictions: Dict[str, List[str]], session=None
                            ) -> Dict[str, List[str]]:
    """Inverse lookup: fill each Commons media id's list with the URIs of
    every entity it depicts (parity reference wiki.py:512-524)."""
    results = query_sparql_entities(COMMONS_DEPICTED_ENTITIES_QUERY,
                                    COMMONS_SPARQL_ENDPOINT,
                                    list(depictions.keys()), prefix="sdc:",
                                    session=session)
    for result in results:
        mid = uri_to_qid(result["commons_entity"]["value"])
        if mid in depictions:
            depictions[mid].append(result["depicted_entity"]["value"])
    return depictions


def query_superclasses(entities: Dict[str, dict],
                       wikidata_superclasses_query: str = WIKIDATA_SUPERCLASSES_QUERY,
                       n_levels: Optional[int] = None, session=None
                       ) -> Dict[str, dict]:
    """Query the P279 superclasses of every ``instanceof`` class present
    in ``entities`` — the full transitive closure (``wdt:P279+``) by
    default, or up to ``n_levels`` (path union ``wdt:P279|wdt:P279/…``).
    Returns ``{class_uri: {superclass_uri: binding}}``, which plugs into
    :func:`keep_classes`/:func:`exclude_classes` directly (parity
    reference wiki.py:872-899)."""
    if n_levels:
        steps = ["/".join(["wdt:P279"] * (i + 1)) for i in range(n_levels)]
        levels = "|".join(steps)
    else:
        levels = "wdt:P279+"
    query = wikidata_superclasses_query % ("%s", levels)
    classes = {uri_to_qid(uri)
               for entity in entities.values()
               for uri in entity.get("instanceof", {})}
    results = query_sparql_entities(query, WIKIDATA_ENDPOINT, sorted(classes),
                                    session=session)
    superclasses: Dict[str, dict] = {}
    for result in results:
        class_uri = result["class"]["value"]
        binding = result["subclassof"]
        binding["label"] = result.get("subclassofLabel")
        superclasses.setdefault(class_uri, {})[binding["value"]] = binding
    return superclasses


def query_feminine_labels(entities: Dict[str, dict], session=None
                          ) -> Dict[str, str]:
    """Feminine (P2521) English labels of every class/occupation in
    ``entities`` — used by kilt2vqa's gendered placeholders (parity
    reference wiki.py:908-926)."""
    qids: Set[str] = set()
    for entity in entities.values():
        qids.update(uris_to_qids(entity.get("instanceof", {}).keys()))
        qids.update(uris_to_qids(entity.get("occupation", {}).keys()))
    results = query_sparql_entities(WIKIDATA_FEMININE_QUERY,
                                    WIKIDATA_ENDPOINT, sorted(qids),
                                    session=session)
    feminine_labels: Dict[str, str] = {}
    for result in results:
        feminine_labels.setdefault(result["entity"]["value"],
                                   result["entity_female_label"]["value"])
    return feminine_labels


# --------------------------------------------------------------------------
# Commons REST walk
# --------------------------------------------------------------------------
def query_image(title: str, session=None) -> Optional[dict]:
    """Fetch one image's categories, URL, description, and license
    metadata from the Commons REST API (parity reference wiki.py:670-697;
    the description rides inside extmetadata and is pulled out, the
    redundant Categories metadata entry is dropped)."""
    url = COMMONS_REST_TITLE.format(titles=title)
    try:
        response = request(url, session)
    except Exception as e:  # noqa: BLE001 — per-image tolerance
        warnings.warn(f"query_image({title!r}) failed: {e!r}")
        return None
    pages = bytes2dict(response.content).get("query", {}).get("pages", {})
    if not pages:
        return None
    page = next(iter(pages.values()))
    imageinfo = page.get("imageinfo", [{}])[0]
    categories = ([c.get("title") for c in page["categories"]]
                  if "categories" in page else None)
    extmetadata = imageinfo.get("extmetadata", {})
    extmetadata.pop("Categories", None)
    description = extmetadata.pop("ImageDescription", {})
    return {
        "categories": categories,
        "url": imageinfo.get("url"),
        "description": description,
        "extmetadata": extmetadata,
    }


def query_commons_subcategories(category: str, categories: Dict[str, bool],
                                images: Dict[str, Optional[dict]],
                                max_images: int = 1000,
                                max_categories: int = 100,
                                session=None):
    """Walk a Commons category tree depth-first, collecting images (files
    with VALID_ENCODING extensions, each fetched once via
    :func:`query_image`) until the image or category budget is spent
    (parity reference wiki.py:590-668; this version is iterative and
    never lists the same category twice — the reference's recursion can).
    Subcategories are pushed in reverse so the LIFO stack visits siblings
    in the reference's in-order recursion order — under capped budgets the
    harvested SET depends on visit order, not just dedup semantics.

    ``categories`` maps each DISCOVERED category to True once its members
    have been listed; ``images`` maps file titles to :func:`query_image`
    results. With ``max_images <= 0`` only categories are walked."""
    stack = [category]
    n_listed = 0
    while stack:
        cat = stack.pop()
        if categories.get(cat):
            continue
        url = COMMONS_REST_LIST.format(cmtitle=cat, cmtype="subcat|file")
        try:
            response = request(url, session)
        except Exception as e:  # noqa: BLE001 — partial walks are useful
            warnings.warn(f"category listing failed for {cat!r}: {e!r}")
            continue
        members = (bytes2dict(response.content)
                   .get("query", {}).get("categorymembers"))
        if members is None:
            continue
        categories[cat] = True
        n_listed += 1
        subcats = []
        for member in members:
            title = member["title"]
            if member["type"] == "file" and max_images > 0:
                if title in images:
                    continue
                if title.split(".")[-1].lower() not in VALID_ENCODING:
                    continue
                images[title] = query_image(title, session)
            elif member["type"] == "subcat":
                if title not in categories:
                    categories[title] = False
                    subcats.append(title)
        stack.extend(reversed(subcats))
        if len(images) > max_images:
            break
        if max_images > 0 and n_listed > max_categories:
            break
        if max_images <= 0 and len(categories) > max_categories:
            break
    return categories, images


def update_from_commons_rest(entities: Dict[str, dict],
                             max_images: int = 1000,
                             max_categories: int = 100,
                             session=None) -> Dict[str, dict]:
    """Harvest each entity's Commons category tree (P373) into ``images``
    and ``categories`` attributes; entities without questions or a
    Commons category are skipped (parity reference wiki.py:716-734)."""
    n_with_commons = 0
    for entity in entities.values():
        if entity.get("n_questions", 0) < 1 or "commons" not in entity:
            continue
        n_with_commons += 1
        categories: Dict[str, bool] = {}
        images: Dict[str, Optional[dict]] = {}
        query_commons_subcategories(
            "Category:" + entity["commons"]["value"], categories, images,
            max_images=max_images, max_categories=max_categories,
            session=session)
        entity["images"] = images
        entity["categories"] = categories
    print(f"{n_with_commons} entities out of {len(entities)} have a root "
          "Commons category and questions in the dataset")
    return entities


def save_image(url: str, directory, session=None,
               max_name_len: int = 240) -> Optional[Path]:
    """Download one Commons image into ``directory`` (named by its file
    name), skipping existing files and over-long names that would exceed
    filesystem limits (parity reference wiki.py:698-715)."""
    import requests as _requests

    file_name = thumbnail_to_file_name(url, original=False)
    if len(file_name) > max_name_len:
        return None
    image_path = Path(directory) / file_name
    if not image_path.exists():
        try:
            response = request(_requests.utils.quote(url, safe=":/"), session)
        except Exception as e:  # noqa: BLE001 — per-image tolerance
            warnings.warn(f"save_image({url!r}) failed: {e!r}")
            return None
        image_path.write_bytes(response.content)
    return image_path
