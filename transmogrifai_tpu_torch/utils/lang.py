"""Per-language text analysis: language identification over 30+ languages,
language-aware stopword sets, and Snowball-style suffix stemmers (the port's
copy of ``transmogrifai_tpu/utils/lang.py``: the same profiles, stop sets
and stemmers, so both packages detect, analyze and hash alike).

The roles it takes from the TransmogrifAI text stack:
- optimaize LanguageDetector (core/.../utils/text/Language.scala + the
  TextTokenizer auto-detect path, TextTokenizer.scala:1-260): 70+ language
  id from character n-gram profiles.  Here: a script fast-path (non-Latin
  scripts identify near-deterministically from Unicode blocks) plus
  Cavnar–Trenkle rank-order char-n-gram profiles built at import time from
  embedded seed texts for the Latin/Cyrillic alphabet languages.
- Lucene per-language analyzers (LuceneTextAnalyzer.scala:1-236): stemmed,
  stopword-filtered tokenization per language.  Here: ordered
  longest-suffix-first strip rules per language (Snowball-style, compact),
  with English following a Porter-lite multi-step pass.

Everything is host-side string work — tokens leave this module as hashed
integer ids; nothing here touches the device.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Dict, FrozenSet, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Seed texts (author-written sample prose, ~40-80 words per language) used to
# build the char-n-gram rank profiles at import time.  These are NOT the test
# fixtures — tests use disjoint sentences.
# ---------------------------------------------------------------------------

SEED_TEXTS: Dict[str, str] = {
    "en": ("the quick brown fox jumps over the lazy dog and then runs back "
           "home because it was getting late in the evening when all the "
           "children were already sleeping and the lights of the town went "
           "out one by one while the rain kept falling softly on the roofs"),
    "es": ("el rápido zorro marrón salta sobre el perro perezoso y luego "
           "vuelve corriendo a casa porque se estaba haciendo tarde por la "
           "noche cuando todos los niños ya estaban durmiendo y las luces de "
           "la ciudad se apagaban una por una mientras la lluvia seguía "
           "cayendo suavemente sobre los tejados"),
    "fr": ("le rapide renard brun saute par dessus le chien paresseux et "
           "puis rentre chez lui en courant parce qu'il se faisait tard le "
           "soir quand tous les enfants dormaient déjà et que les lumières "
           "de la ville s'éteignaient une à une pendant que la pluie "
           "continuait de tomber doucement sur les toits"),
    "de": ("der schnelle braune fuchs springt über den faulen hund und läuft "
           "dann nach hause zurück weil es am abend schon spät wurde als "
           "alle kinder bereits schliefen und die lichter der stadt eines "
           "nach dem anderen ausgingen während der regen weiter leise auf "
           "die dächer fiel"),
    "it": ("la veloce volpe marrone salta sopra il cane pigro e poi torna a "
           "casa di corsa perché si stava facendo tardi la sera quando "
           "tutti i bambini dormivano già e le luci della città si "
           "spegnevano una dopo l'altra mentre la pioggia continuava a "
           "cadere dolcemente sui tetti"),
    "pt": ("a rápida raposa marrom pula sobre o cão preguiçoso e depois "
           "volta correndo para casa porque estava ficando tarde à noite "
           "quando todas as crianças já estavam dormindo e as luzes da "
           "cidade se apagavam uma a uma enquanto a chuva continuava caindo "
           "suavemente sobre os telhados "
           # everyday register — keeps pt apart from gl on short strings
           "bom dia queria perguntar se vocês têm horário livre para "
           "amanhã à tarde preciso levar o carro até a oficina e não sei "
           "quanto vai custar obrigado pela resposta me escreva por favor "
           "o quanto antes ou ligue para o número que deixei na semana "
           "passada compramos sapatos novos na loja mas ficaram pequenos "
           "então vamos ter que trocar a fatura chega sempre até "
           "sexta-feira e o celular continua reiniciando depois da "
           "atualização"),
    "nl": ("de snelle bruine vos springt over de luie hond en rent daarna "
           "terug naar huis omdat het al laat werd in de avond toen alle "
           "kinderen al sliepen en de lichten van de stad een voor een "
           "uitgingen terwijl de regen zachtjes op de daken bleef vallen"),
    "ru": ("быстрая коричневая лиса прыгает через ленивую собаку и потом "
           "бежит домой потому что вечером уже становилось поздно когда все "
           "дети уже спали и огни города гасли один за другим пока дождь "
           "продолжал тихо падать на крыши домов "
           # everyday register (requests, errands) — short strings need
           # n-grams from common verbs and clitics, not just narrative
           "добрый день хотел спросить есть ли у вас свободное время на "
           "завтра после обеда мне нужно отвезти машину в сервис и я не "
           "знаю сколько это будет стоить спасибо большое за ответ "
           "напишите мне пожалуйста как можно скорее или позвоните по "
           "номеру который я оставил на прошлой неделе в магазине мы "
           "купили новые ботинки но они оказались малы поэтому их нужно "
           "поменять после обновления программа работает лучше"),
    "uk": ("швидка коричнева лисиця стрибає через ледачого пса і потім "
           "біжить додому бо ввечері вже ставало пізно коли всі діти вже "
           "спали і вогні міста гасли один за одним поки дощ продовжував "
           "тихо падати на дахи будинків "
           "добрий день хотів запитати чи є у вас вільне місце на завтра "
           "після обіду мені треба відвезти машину в сервіс і я не знаю "
           "скільки це коштуватиме дякую за відповідь напишіть мені будь "
           "ласка якнайшвидше або зателефонуйте за номером який я залишив "
           "минулого тижня в магазині ми купили нові черевики але вони "
           "виявилися малі тому їх треба поміняти"),
    "pl": ("szybki brązowy lis skacze nad leniwym psem a potem biegnie z "
           "powrotem do domu ponieważ wieczorem robiło się już późno kiedy "
           "wszystkie dzieci już spały a światła miasta gasły jedno po "
           "drugim podczas gdy deszcz nadal cicho padał na dachy domów"),
    "cs": ("rychlá hnědá liška skáče přes líného psa a potom běží zpátky "
           "domů protože večer už bylo pozdě když všechny děti už spaly a "
           "světla města zhasínala jedno po druhém zatímco déšť dál tiše "
           "padal na střechy domů "
           # everyday register (requests, work, errands) — the short-string
           # case needs n-grams from common verbs and clitics, not just the
           # narrative passage above
           "dobrý den chtěl bych se zeptat jestli máte ještě volné místo "
           "na zítřejší odpoledne musím totiž odvézt auto do servisu a "
           "nevím kolik to bude stát děkuji moc za odpověď napište mi "
           "prosím co nejdřív nebo zavolejte na moje číslo které jsem vám "
           "dal minulý týden v obchodě jsme koupili nové boty ale jsou "
           "nám malé takže je musíme vyměnit"),
    "sk": ("rýchla hnedá líška skáče cez lenivého psa a potom beží späť "
           "domov pretože večer už bolo neskoro keď všetky deti už spali a "
           "svetlá mesta zhasínali jedno po druhom zatiaľ čo dážď ďalej "
           "ticho padal na strechy domov "
           "dobrý deň chcel by som sa opýtať či máte ešte voľné miesto na "
           "zajtrajšie popoludnie musím totiž odviezť auto do servisu a "
           "neviem koľko to bude stáť ďakujem pekne za odpoveď napíšte mi "
           "prosím čo najskôr alebo zavolajte na moje číslo ktoré som vám "
           "dal minulý týždeň v obchode sme kúpili nové topánky ale sú "
           "nám malé takže ich musíme vymeniť"),
    "ro": ("vulpea maro rapidă sare peste câinele leneș și apoi aleargă "
           "înapoi acasă pentru că se făcea târziu seara când toți copiii "
           "dormeau deja și luminile orașului se stingeau una câte una în "
           "timp ce ploaia continua să cadă încet pe acoperișuri "
           "bună ziua aș vrea să întreb dacă mai aveți locuri libere "
           "pentru mâine după amiază trebuie să duc mașina la service și "
           "nu știu cât o să coste mulțumesc frumos pentru răspuns "
           "scrieți-mi vă rog cât mai repede sau sunați-mă la numărul pe "
           "care vi l-am dat săptămâna trecută am cumpărat pantofi noi "
           "din magazin dar ne sunt mici așa că trebuie să îi schimbăm"),
    "hu": ("a gyors barna róka átugrik a lusta kutya fölött aztán "
           "hazaszalad mert este már későre járt amikor a gyerekek már mind "
           "aludtak és a város fényei egymás után aludtak ki miközben az "
           "eső tovább hullott halkan a háztetőkre "
           "jó napot kívánok szeretném megkérdezni hogy van-e még szabad "
           "hely holnap délutánra ugyanis el kell vinnem az autót a "
           "szervizbe és nem tudom mennyibe fog kerülni köszönöm szépen a "
           "választ kérem írjon minél hamarabb vagy hívjon fel azon a "
           "számon amit múlt héten adtam meg a boltban új cipőt vettünk "
           "de kicsi lett ezért ki kell cserélnünk"),
    "fi": ("nopea ruskea kettu hyppää laiskan koiran yli ja juoksee sitten "
           "takaisin kotiin koska illalla alkoi jo olla myöhä kun kaikki "
           "lapset jo nukkuivat ja kaupungin valot sammuivat yksi "
           "toisensa jälkeen samalla kun sade jatkoi hiljaista "
           "putoamistaan katoille"),
    "sv": ("den snabba bruna räven hoppar över den lata hunden och springer "
           "sedan tillbaka hem eftersom det redan började bli sent på "
           "kvällen när alla barnen redan sov och stadens ljus slocknade "
           "ett efter ett medan regnet fortsatte att falla mjukt på taken "
           "hej jag undrar om ni har en ledig tid i morgon eftermiddag "
           "jag måste nämligen lämna in bilen på verkstaden och vet inte "
           "vad det kommer att kosta tack för svaret skriv gärna så "
           "snabbt som möjligt eller ring mig på numret jag gav er förra "
           "veckan vi köpte nya skor i affären men de är för små så vi "
           "måste byta dem"),
    "no": ("den raske brune reven hopper over den late hunden og løper så "
           "tilbake hjem fordi det allerede begynte å bli sent på kvelden "
           "da alle barna allerede sov og byens lys slukket ett etter ett "
           "mens regnet fortsatte å falle stille på takene "
           "hei jeg lurer på om dere har ledig time i morgen ettermiddag "
           "jeg må nemlig levere bilen på verksted og vet ikke hva det "
           "kommer til å koste takk for svaret skriv gjerne så fort som "
           "mulig eller ring meg på nummeret jeg ga dere forrige uke vi "
           "kjøpte nye sko i butikken men de er for små så vi må bytte "
           "dem "
           # distinctly norwegian orthography (hva/nå/uke/ikke noe/veldig)
           "hva skjer nå spurte hun og så ut av vinduet det var ikke noe "
           "særlig å se bare noen måker over brygga og en gammel båt som "
           "lå og vugget vi hadde vært der en hel uke og det regnet "
           "nesten hver eneste dag men det gjorde ikke så mye for vi "
           "hadde det veldig hyggelig likevel og etterpå gikk vi opp på "
           "fjellet da været endelig ble bedre"),
    "da": ("den hurtige brune ræv springer over den dovne hund og løber så "
           "tilbage hjem fordi det allerede var ved at blive sent om "
           "aftenen da alle børnene allerede sov og byens lys slukkede et "
           "efter et mens regnen blev ved med at falde blidt på tagene "
           "hej jeg vil gerne høre om i har en ledig tid i morgen "
           "eftermiddag jeg skal nemlig aflevere bilen på værksted og ved "
           "ikke hvad det kommer til at koste tak for svaret skriv gerne "
           "så hurtigt som muligt eller ring til mig på det nummer jeg "
           "gav jer i sidste uge vi købte nye sko i butikken men de er "
           "for små så vi bliver nødt til at bytte dem"),
    "tr": ("hızlı kahverengi tilki tembel köpeğin üzerinden atlar ve sonra "
           "eve geri koşar çünkü akşam artık geç oluyordu bütün çocuklar "
           "çoktan uyurken ve şehrin ışıkları birer birer sönerken yağmur "
           "çatılara usulca yağmaya devam ediyordu"),
    "el": ("η γρήγορη καφέ αλεπού πηδάει πάνω από το τεμπέλικο σκυλί και "
           "μετά τρέχει πίσω στο σπίτι γιατί το βράδυ είχε ήδη αρχίσει να "
           "νυχτώνει όταν όλα τα παιδιά κοιμόντουσαν ήδη και τα φώτα της "
           "πόλης έσβηναν ένα ένα ενώ η βροχή συνέχιζε να πέφτει απαλά "
           "στις στέγες"),
    "ar": ("الثعلب البني السريع يقفز فوق الكلب الكسول ثم يركض عائدا إلى "
           "المنزل لأن الوقت كان قد تأخر في المساء عندما كان جميع الأطفال "
           "نائمين بالفعل وأضواء المدينة تنطفئ واحدا تلو الآخر بينما "
           "استمر المطر في السقوط بهدوء على الأسطح"),
    "he": ("השועל החום המהיר קופץ מעל הכלב העצלן ואז רץ חזרה הביתה כי "
           "נעשה מאוחר בערב כאשר כל הילדים כבר ישנו ואורות העיר כבו אחד "
           "אחרי השני בזמן שהגשם המשיך ליפול בשקט על הגגות"),
    "fa": ("روباه قهوه‌ای سریع از روی سگ تنبل می‌پرد و سپس به خانه "
           "برمی‌گردد زیرا شب دیر شده بود وقتی همه کودکان خوابیده بودند و "
           "چراغ‌های شهر یکی پس از دیگری خاموش می‌شدند در حالی که باران "
           "همچنان آرام بر بام‌ها می‌بارید"),
    "hi": ("तेज भूरी लोमड़ी आलसी कुत्ते के ऊपर से कूदती है और फिर घर वापस "
           "भागती है क्योंकि शाम को देर हो रही थी जब सभी बच्चे पहले से सो "
           "रहे थे और शहर की बत्तियां एक एक करके बुझ रही थीं जबकि बारिश "
           "छतों पर धीरे धीरे गिरती रही"),
    "bn": ("দ্রুত বাদামী শিয়াল অলস কুকুরের উপর দিয়ে লাফ দেয় এবং তারপর "
           "বাড়ি ফিরে দৌড়ায় কারণ সন্ধ্যায় দেরি হয়ে যাচ্ছিল যখন সব "
           "শিশুরা ইতিমধ্যে ঘুমিয়ে ছিল এবং শহরের আলো একে একে নিভে "
           "যাচ্ছিল যখন বৃষ্টি ছাদে আস্তে আস্তে পড়তে থাকল"),
    "zh": ("敏捷的棕色狐狸跳过懒狗然后跑回家因为晚上已经很晚了所有的孩子"
           "都已经睡着了城市的灯光一盏接一盏地熄灭雨继续轻轻地落在屋顶上"),
    "ja": ("すばやい茶色のキツネは怠け者の犬を飛び越えてそれから家に走って"
           "帰ります夜遅くなってきて子供たちはもう眠っていて町の明かりは"
           "ひとつずつ消えていき雨は屋根の上に静かに降り続けていました"),
    "ko": ("빠른 갈색 여우가 게으른 개를 뛰어넘고 나서 집으로 달려갑니다 "
           "저녁이 이미 늦어지고 있었고 모든 아이들은 이미 잠들어 있었으며 "
           "도시의 불빛은 하나씩 꺼지고 비는 지붕 위에 조용히 계속 "
           "내리고 있었습니다"),
    "th": ("สุนัขจิ้งจอกสีน้ำตาลที่ว่องไวกระโดดข้ามสุนัขขี้เกียจแล้ววิ่งกลับบ้าน"
           "เพราะตอนเย็นเริ่มดึกแล้วเมื่อเด็กทุกคนหลับไปแล้วและแสงไฟของเมือง"
           "ก็ดับลงทีละดวงขณะที่ฝนยังคงตกลงบนหลังคาอย่างเบามือ"),
    "vi": ("con cáo nâu nhanh nhẹn nhảy qua con chó lười biếng rồi chạy về "
           "nhà vì buổi tối đã muộn khi tất cả trẻ em đã ngủ và ánh đèn "
           "thành phố tắt dần từng ngọn một trong khi mưa vẫn tiếp tục rơi "
           "nhẹ nhàng trên những mái nhà"),
    "id": ("rubah coklat yang cepat melompati anjing yang malas lalu "
           "berlari pulang karena malam sudah semakin larut ketika semua "
           "anak anak sudah tertidur dan lampu lampu kota padam satu per "
           "satu sementara hujan terus turun perlahan di atas atap rumah"),
    "sw": ("mbweha mwepesi wa kahawia anaruka juu ya mbwa mvivu kisha "
           "anakimbia kurudi nyumbani kwa sababu jioni ilikuwa imechelewa "
           "wakati watoto wote walikuwa wamelala tayari na taa za mji "
           "zilizimika moja baada ya nyingine huku mvua ikiendelea kunyesha "
           "polepole juu ya mapaa"),
    # --- nine more toward optimaize's ~70 ---
    "bg": ("бързата кафява лисица прескача мързеливото куче и после тича "
           "обратно към къщи защото вечерта вече ставаше късно когато "
           "всички деца вече спяха и светлините на града угасваха една "
           "след друга докато дъждът продължаваше да пада тихо върху "
           "покривите добър ден бих искал да попитам дали имате свободно "
           "място за утре следобед трябва да закарам колата на сервиз и не "
           "знам колко ще струва благодаря много за отговора"),
    "ca": ("la ràpida guineu marró salta per sobre del gos mandrós i "
           "després torna corrents cap a casa perquè es feia tard al "
           "vespre quan tots els nens ja dormien i els llums de la ciutat "
           "s'apagaven un darrere l'altre mentre la pluja continuava "
           "caient suaument sobre les teulades bon dia voldria preguntar "
           "si teniu lloc lliure per demà a la tarda haig de portar el "
           "cotxe al taller i no sé quant costarà moltes gràcies per la "
           "resposta escriviu-me si us plau tan aviat com pugueu"),
    "gl": ("o rápido raposo marrón salta por riba do can preguiceiro e "
           "despois volve correndo á casa porque se estaba a facer tarde "
           "pola noite cando todos os nenos xa durmían e as luces da "
           "cidade apagábanse unha tras outra mentres a chuvia seguía "
           "caendo suavemente sobre os tellados bo día quería preguntar "
           "se tedes sitio libre para mañá pola tarde teño que levar o "
           "coche ao taller e non sei canto vai custar moitas grazas pola "
           "resposta escribídeme por favor canto antes"),
    "lt": ("greita ruda lapė peršoka per tingų šunį ir paskui bėga atgal "
           "namo nes vakare jau buvo vėlu kai visi vaikai jau miegojo ir "
           "miesto šviesos geso viena po kitos kol lietus toliau tyliai "
           "krito ant stogų laba diena norėčiau paklausti ar turite "
           "laisvą vietą rytojaus popietei nes turiu nuvežti automobilį į "
           "servisą ir nežinau kiek tai kainuos labai ačiū už atsakymą "
           "parašykite man prašau kuo greičiau"),
    "lv": ("ātrā brūnā lapsa pārlec pār slinko suni un tad skrien atpakaļ "
           "mājās jo vakarā jau kļuva vēls kad visi bērni jau gulēja un "
           "pilsētas gaismas dzisa viena pēc otras kamēr lietus turpināja "
           "klusi krist uz jumtiem labdien es vēlētos pajautāt vai jums "
           "ir brīva vieta rītdienas pēcpusdienai jo man jāaizved "
           "automašīna uz servisu un es nezinu cik tas maksās liels "
           "paldies par atbildi lūdzu uzrakstiet man pēc iespējas ātrāk"),
    "et": ("kiire pruun rebane hüppab üle laisa koera ja jookseb siis "
           "koju tagasi sest õhtul läks juba hiljaks kui kõik lapsed "
           "juba magasid ja linna tuled kustusid üksteise järel samal "
           "ajal kui vihm jätkas vaikselt katustele langemist tere "
           "sooviksin küsida kas teil on homme pärastlõunal vaba aega "
           "sest pean auto töökotta viima ja ma ei tea kui palju see "
           "maksma läheb suur tänu vastuse eest kirjutage mulle palun "
           "võimalikult kiiresti"),
    "hr": ("brza smeđa lisica preskače lijenog psa i zatim trči natrag "
           "kući jer je navečer već postajalo kasno kada su sva djeca "
           "već spavala i svjetla grada gasila su se jedno za drugim dok "
           "je kiša i dalje tiho padala po krovovima dobar dan htio bih "
           "pitati imate li slobodno mjesto za sutra poslijepodne moram "
           "odvesti auto u servis i ne znam koliko će to koštati puno "
           "hvala na odgovoru napišite mi molim vas što prije"),
    "sl": ("hitra rjava lisica skoči čez lenega psa in nato teče nazaj "
           "domov ker je zvečer postajalo že pozno ko so vsi otroci že "
           "spali in so luči mesta ugašale ena za drugo medtem ko je dež "
           "še naprej tiho padal na strehe dober dan rad bi vprašal ali "
           "imate prosto mesto za jutri popoldne ker moram peljati avto "
           "na servis in ne vem koliko bo to stalo najlepša hvala za "
           "odgovor prosim pišite mi čim prej"),
    "az": ("sürətli qəhvəyi tülkü tənbəl itin üstündən tullanır və sonra "
           "evə geri qaçır çünki axşam artıq gec olurdu bütün uşaqlar "
           "artıq yatmışdı və şəhərin işıqları bir bir sönürdü yağış "
           "damların üzərinə yavaş yavaş yağmağa davam edirdi salam "
           "sabah günorta üçün boş yeriniz olub olmadığını soruşmaq "
           "istəyirəm maşını servisə aparmalıyam və nə qədər baha "
           "olacağını bilmirəm cavab üçün çox sağ olun"),
}

LANGUAGES: Tuple[str, ...] = tuple(sorted(SEED_TEXTS))


# ---------------------------------------------------------------------------
# Script fast-path: non-Latin scripts identify (nearly) deterministically
# ---------------------------------------------------------------------------

_SCRIPT_RANGES = (
    # (start, end, script tag)
    (0x0370, 0x03FF, "greek"), (0x0400, 0x04FF, "cyrillic"),
    (0x0530, 0x058F, "armenian"), (0x0590, 0x05FF, "hebrew"),
    (0x0600, 0x06FF, "arabic"), (0x0750, 0x077F, "arabic"),
    (0x0900, 0x097F, "devanagari"), (0x0980, 0x09FF, "bengali"),
    (0x0E00, 0x0E7F, "thai"), (0x10A0, 0x10FF, "georgian"),
    (0x1100, 0x11FF, "hangul"), (0x3040, 0x309F, "kana"),
    (0x30A0, 0x30FF, "kana"), (0x4E00, 0x9FFF, "han"),
    (0xAC00, 0xD7AF, "hangul"),
)

# Persian-specific letters: پ چ ژ گ plus the Farsi yeh (U+06CC) and keheh
# (U+06A9), which Persian orthography uses where Arabic writes ي / ك
_PERSIAN_CHARS = set("پچژگیک")
_UKRAINIAN_CHARS = set("іїєґ")
_RUSSIAN_CHARS = set("ыэё")


def _script_counts(text: str) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for ch in text:
        cp = ord(ch)
        if cp < 0x0370:
            if ch.isalpha():
                counts["latin"] = counts.get("latin", 0) + 1
            continue
        for lo, hi, tag in _SCRIPT_RANGES:
            if lo <= cp <= hi:
                counts[tag] = counts.get(tag, 0) + 1
                break
    return counts


def _script_language(text: str, counts: Dict[str, int]) -> Optional[str]:
    """Resolve languages whose script decides them; None for Latin/Cyrillic."""
    total = sum(counts.values())
    if total == 0:
        return None
    top = max(counts, key=counts.get)
    if counts[top] / total < 0.4:
        return None
    if top == "greek":
        return "el"
    if top == "hebrew":
        return "he"
    if top == "arabic":
        return "fa" if any(c in _PERSIAN_CHARS for c in text) else "ar"
    if top == "devanagari":
        return "hi"
    if top == "bengali":
        return "bn"
    if top == "thai":
        return "th"
    if top == "hangul":
        return "ko"
    if top == "kana":
        return "ja"
    if top == "han":
        # han + any kana = Japanese; pure han = Chinese
        return "ja" if counts.get("kana") else "zh"
    return None  # latin / cyrillic need n-gram profiles


# ---------------------------------------------------------------------------
# Cavnar–Trenkle char-n-gram rank profiles
# ---------------------------------------------------------------------------

_PROFILE_SIZE = 300
_WORD_RE = re.compile(r"[^\W\d_]+", re.UNICODE)


def _text_ngrams(text: str) -> Dict[str, int]:
    """1-3 char n-grams over space-padded lowercase words."""
    counts: Dict[str, int] = {}
    for w in _WORD_RE.findall(text.lower()):
        padded = f" {w} "
        for n in (1, 2, 3):
            for i in range(len(padded) - n + 1):
                g = padded[i:i + n]
                counts[g] = counts.get(g, 0) + 1
    return counts


def _rank_profile(counts: Dict[str, int], size: int = _PROFILE_SIZE
                  ) -> Dict[str, int]:
    top = sorted(counts, key=lambda g: (-counts[g], g))[:size]
    return {g: r for r, g in enumerate(top)}


_PROFILES: Dict[str, Dict[str, int]] = {}


def _profiles() -> Dict[str, Dict[str, int]]:
    if not _PROFILES:
        for lang, seed in SEED_TEXTS.items():
            _PROFILES[lang] = _rank_profile(_text_ngrams(seed))  # opcheck: allow(TM306) lazy table of constants: racing writers store one value
    return _PROFILES


def _rank_distance(doc: Dict[str, int], profile: Dict[str, int]) -> float:
    """Out-of-place distance (Cavnar–Trenkle 1994), normalized per n-gram."""
    if not doc:
        return float(_PROFILE_SIZE)
    dist = 0
    for g, r in doc.items():
        pr = profile.get(g)
        dist += abs(r - pr) if pr is not None else _PROFILE_SIZE
    return dist / len(doc)


def detect_language_scores(text: Optional[str]) -> Dict[str, float]:
    """language -> confidence over LANGUAGES (optimaize detectLanguages role).

    Script-decidable inputs return {lang: 1.0}; alphabetic scripts score all
    same-script profiles by inverted rank distance, normalized to sum to 1
    over the 3 closest candidates."""
    if not text or not text.strip():
        return {}
    counts = _script_counts(text)
    if not counts:
        return {}
    scripted = _script_language(text, counts)
    if scripted is not None:
        return {scripted: 1.0}
    # cyrillic: ru vs uk vs bg
    if counts.get("cyrillic", 0) > counts.get("latin", 0):
        low = text.lower()
        if any(c in _UKRAINIAN_CHARS for c in low):
            return {"uk": 1.0}
        # ы / э / ё exist in the Russian alphabet but in neither the
        # Ukrainian nor the Bulgarian one — almost every Russian sentence
        # carries at least one
        if any(c in _RUSSIAN_CHARS for c in low):
            return {"ru": 1.0}
        candidates = ("ru", "uk", "bg")
    else:
        # Azerbaijani schwa appears in nearly every az sentence and in no
        # other Latin-script language here — decide before profiles (the
        # az/tr n-gram profiles are otherwise close)
        if "ə" in text.lower():
            return {"az": 1.0}
        candidates = tuple(l for l in LANGUAGES if l not in (
            "el", "he", "ar", "fa", "hi", "bn", "th", "ko", "ja", "zh",
            "ru", "uk", "bg"))
    doc = _rank_profile(_text_ngrams(text))
    profs = _profiles()
    # rank distance blended with a function-word overlap bonus: short inputs
    # carry few trigrams, but their words are mostly function words, which
    # the per-language stopword sets identify very sharply
    words = [w for w in _WORD_RE.findall(text.lower())]
    nw = max(len(words), 1)
    dists = {}
    for l in candidates:
        d = _rank_distance(doc, profs[l])
        stops = STOPWORDS.get(l)
        if stops:
            overlap = sum(1 for w in words if w in stops) / nw
            d *= (1.0 - 0.6 * overlap)
        dists[l] = d
    best3 = sorted(dists, key=dists.get)[:3]
    # inverted-distance weights over the top 3 (sharper than raw inverses)
    inv = {l: 1.0 / max(dists[l], 1e-9) ** 2 for l in best3}
    tot = sum(inv.values())
    return {l: inv[l] / tot for l in sorted(inv, key=inv.get, reverse=True)}


def detect_language(text: Optional[str]) -> str:
    """Best language id, 'unknown' when no signal."""
    scores = detect_language_scores(text)
    if not scores:
        return "unknown"
    return max(scores, key=scores.get)


# ---------------------------------------------------------------------------
# Stopword sets (high-frequency function words per language)
# ---------------------------------------------------------------------------

STOPWORDS: Dict[str, FrozenSet[str]] = {
    "en": frozenset("""a an and are as at be but by for if in into is it no
        not of on or such that the their then there these they this to was
        will with you he she we i his her its our your from has have had do
        does did when where which who whom how why what all any both each
        so than too very can just should now""".split()),
    "es": frozenset("""de la que el en y a los del se las por un para con no
        una su al lo como más pero sus le ya o este sí porque esta entre
        cuando muy sin sobre también me hasta hay donde quien desde todo nos
        durante todos uno les ni contra otros ese eso ante ellos e esto mí
        antes algunos qué unos yo otro otras otra él tanto esa estos mucho
        quienes nada muchos cual poco ella estar estas algunas algo
        nosotros""".split()),
    "fr": frozenset("""de la le et les des en un du une que est pour qui
        dans a par plus pas au sur ne se ce il sont avec son ses mais comme
        ou si leur y dont elle deux tout nous sa vous je tu ils elles cette
        ces mon ton notre votre on être avoir fait faire aux même aussi
        bien encore là où quand sans sous entre après avant chez""".split()),
    "de": frozenset("""der die und in den von zu das mit sich des auf für
        ist im dem nicht ein eine als auch es an werden aus er hat dass sie
        nach wird bei einer um am sind noch wie einem über einen so zum war
        haben nur oder aber vor zur bis mehr durch man sein wurde sei ich
        du wir ihr ihre seinen ihren kann wenn doch schon""".split()),
    "it": frozenset("""di e il la che a in un per è una sono da con non si
        le dei come lo più nel alla ha gli i delle questo ma anche
        della suo hanno al dal se loro o quando nella ci sua degli
        essere molto tutti tutto questa era dopo senza due prima così noi
        lui lei io tu voi essi fare può quello questi""".split()),
    "pt": frozenset("""de a o que e do da em um para é com não uma os no se
        na por mais as dos como mas foi ao ele das tem à seu sua ou ser
        quando muito há nos já está eu também só pelo pela até isso ela
        entre era depois sem mesmo aos ter seus quem nas me esse eles estão
        você tinha foram essa num nem suas meu às minha têm numa pelos elas
        havia seja qual será nós tenho lhe deles essas esses pelas este
        fosse dele""".split()),
    "nl": frozenset("""de het een en van in is dat op te zijn met voor niet
        aan er om ook als maar dan bij nog uit naar door over zo hij ik je
        ze we wat worden werd kan geen meer al deze die dit heeft hebben tot
        was wordt of mijn haar hun ons onze jullie men wel moet zou""".split()),
    "ru": frozenset("""и в не на я что он с как это по но они к у же вы за
        бы мы от она так его то все а о её ему только меня было бы когда
        уже для вот кто да нет ли если или ни быть был них нас
        их чем мне есть про этот тот где даже под будет тогда себя ничего
        может здесь надо там потом очень через эти один такой""".split()),
    "pl": frozenset("""i w nie na się że z do to jest jak po co tak za od a
        o ale czy przez przy ja ty my wy oni przed być był była było są
        będzie ich jego jej nas was im tym tego też tylko może już bardzo
        kiedy gdzie który która które dla bez pod nad""".split()),
    "sv": frozenset("""och i att det som en på är av för med den till ett
        om har de inte jag du vi ni han hon sig men ska var sin kan när så
        här där vad alla våra din min sitt mot efter under mellan""".split()),
    "da": frozenset("""og i at det som en på er af for med den til et om
        har de ikke jeg du vi han hun sig men skal var sin kan når så her
        der hvad alle vores din min sit mod efter under mellem""".split()),
    "no": frozenset("""og i å at det som en på er av for med den til et om
        har de ikke jeg du vi han hun seg men skal var sin kan når så her
        der hva alle våre din min sitt mot etter under mellom""".split()),
    "fi": frozenset("""ja on ei se että en oli hän mutta ovat joka kun mitä
        niin kuin myös jos siitä sen ole tai vain sitä tämä hänen he me te
        minä sinä nyt jo vielä kaikki mukaan sekä""".split()),
    "tr": frozenset("""ve bir bu da de için ile o ben sen biz siz onlar ama
        gibi daha çok en ne var yok mi mı mu mü olarak sonra önce kadar her
        şey ki ya hem ise değil olan bunu onun""".split()),
    "id": frozenset("""yang dan di ke dari untuk pada adalah ini itu dengan
        tidak dalam akan ada juga saya kamu dia kami mereka atau tetapi
        karena sudah telah bisa harus oleh sebagai lebih sangat satu
        dua""".split()),
    "cs": frozenset("""a i v na je se že s z o do pro ale jako by bylo být
        jsem jsi jsou byl byla ten ta to tento tato toto který která
        které kde když už jen také ještě nebo při od po za před mezi bez
        co jak tak jeho její jejich nás vás""".split()),
    "sk": frozenset("""a aj v na je sa že s z o do pre ale ako by bolo byť
        som si sú bol bola ten tá to tento táto toto ktorý ktorá ktoré
        kde keď už len tiež ešte alebo pri od po za pred medzi bez čo
        ako tak jeho jej ich nás vás""".split()),
    "ro": frozenset("""și în de la cu pe un o a al ai ale că nu este sunt
        era fi fost mai dar sau dacă când unde care cine ce cum pentru
        prin după între fără sub peste acest această acestei lui ei lor
        noi voi se își""".split()),
    "hu": frozenset("""a az és hogy nem is egy ez az volt van lesz már
        csak meg de ha mint még el ki be fel le mert vagy pedig én te ő
        mi ti ők ezt azt ezek azok mind minden nagyon itt ott ahol
        amikor aki ami""".split()),
    "el": frozenset("""ο η το οι τα του της των τον την και να με σε για
        από που δεν θα είναι ήταν έχει είχε αυτό αυτή αυτός ως κατά μετά
        πριν χωρίς πάνω κάτω μέσα έξω ένα μια πολύ πιο όπως όταν αλλά ή
        αν τι πως""".split()),
    # --- more analyzer languages ---
    "ar": frozenset("""في من على إلى عن أن إن كان كانت هذا هذه ذلك التي
        الذي ما لا لم لن قد كل بعد قبل عند حتى هو هي هم نحن أنا أنت ثم
        أو و يا إذا لكن بين غير سوف هناك حيث كما أي مع منذ عندما لأن""".split()),
    "fa": frozenset("""و در به از که این آن را با برای است بود شد های می
        هم او ما شما آنها من تو یک دو تا هر اگر اما یا نیز پس چون بر
        چه کرد شده باید خود دیگر هیچ همه وقتی چرا کجا""".split()),
    "hi": frozenset("""का के की है में और से को पर यह वह एक ने हैं था थी
        थे हो गया गई कर रहा रही रहे लिए भी नहीं तो ही कि जो अब तक साथ
        बाद फिर कुछ सब अपने उनके इसके हम तुम आप वे मैं क्या कब कहाँ""".split()),
    "uk": frozenset("""і в не на я що він з як це по але вони до у же ви
        за ми від вона так його то все а о її йому тільки мене було коли
        вже для хто ні якщо або бути був них нас їх чим мені є про цей
        той де навіть під буде тоді себе нічого може тут треба там потім
        дуже через ці один такий""".split()),
    "bg": frozenset("""и в не на аз що той с как това по но те до у же
        вие за ние от тя така го то всичко а о ѝ му само мене беше кога
        вече за кой не ако или да бил тях нас им какво ми е при този онзи
        къде дори под ще тогава себе нищо може тук трябва там после
        много през тези един такъв се са като ли""".split()),
    "ca": frozenset("""el la els les un una de del dels i en a per amb que
        és són era no hi ha més però com si o ja molt poc tot tots aquest
        aquesta això allò seu seva meu meva nostre vostre jo tu ell ella
        nosaltres vosaltres quan on qui què perquè sense sobre entre
        fins des també només""".split()),
    "gl": frozenset("""o a os as un unha de do dos da das e en por para
        con que é son era non hai máis pero como se ou xa moi pouco todo
        todos este esta isto aquilo seu súa meu miña noso voso eu ti el
        ela nós vós cando onde quen que porque sen sobre entre ata desde
        tamén só""".split()),
    "lt": frozenset("""ir yra į iš su be per po prie už kad kaip bet ar
        jau dar tik taip pat labai čia ten kur kada kas jis ji mes jūs aš
        tu jie jos šis ši tas ta visi visos savo mano tavo mūsų jūsų
        buvo bus būti nėra prieš tarp apie nuo iki""".split()),
    "lv": frozenset("""un ir uz no ar bez par pēc pie aiz ka kā bet vai
        jau vēl tikai tā arī ļoti šeit tur kur kad kas viņš viņa mēs jūs
        es tu viņi viņas šis šī tas tā visi visas savs mans tavs mūsu
        jūsu bija būs būt nav pirms starp ap līdz""".split()),
    "et": frozenset("""ja on ei see et oli ta aga nad kui mis nii nagu ka
        siis veel ainult siin seal kus millal kes tema meie teie mina
        sina nemad kõik oma minu sinu enne vahel umbes kuni juba väga
        pärast ilma koos üle alla sisse välja ning või ning olema pole""".split()),
    # detection-only sets (no analyzers yet): overlap bonus for short strings
    "hr": frozenset("""i u na je se da su za s o od do kao ali ili već
        još samo tako vrlo ovdje tamo gdje kada tko što on ona mi vi ja
        ti oni ove ovaj ta taj svi sve svoj moj tvoj naš vaš bio bila
        biti nije prije između oko""".split()),
    "sl": frozenset("""in v na je se da so za s o od do kot ali pa že še
        samo tako zelo tukaj tam kje kdaj kdo kaj on ona mi vi jaz ti
        oni ta ti vsi vse svoj moj tvoj naš vaš bil bila biti ni pred
        med okoli""".split()),
    "az": frozenset("""və bir bu da də üçün ilə o mən sən biz siz onlar
        amma kimi daha çox ən nə var yox sonra əvvəl qədər hər şey ki ya
        həm isə deyil olan bunu onun""".split()),
}


def stop_words_for(language: str) -> FrozenSet[str]:
    """Language stopword set; falls back to English."""
    return STOPWORDS.get(language, STOPWORDS["en"])


# ---------------------------------------------------------------------------
# Snowball-style stemmers
# ---------------------------------------------------------------------------

def _suffix_stemmer(pairs: List[Tuple[str, str]], min_stem: int = 3):
    """Ordered longest-suffix-first single-strip stemmer."""
    rules = sorted(pairs, key=lambda p: -len(p[0]))

    def stem(w: str) -> str:
        for suf, rep in rules:
            if w.endswith(suf) and (len(w) - len(suf) + len(rep)) >= min_stem:
                return w[: len(w) - len(suf)] + rep
        return w

    return stem


_VOWELS_EN = set("aeiouy")


def _stem_en(w: str) -> str:
    """Porter-lite English stemmer: plural + participle + common
    derivational suffixes, with the classic undouble/e-restore fixes."""
    if len(w) <= 3:
        return w
    # step 1a: plurals
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-3] + "i"
    elif w.endswith("ss"):
        pass
    elif w.endswith("s") and len(w) > 3:
        w = w[:-1]
    # step 1b: ed / ing
    for suf in ("ingly", "edly", "ing", "ed"):
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if any(c in _VOWELS_EN for c in stem) and len(stem) >= 2:
                if stem.endswith(("at", "bl", "iz")):
                    stem += "e"
                elif (len(stem) >= 2 and stem[-1] == stem[-2]
                      and stem[-1] not in "lsz"):
                    stem = stem[:-1]
                elif (len(stem) == 3 and stem[0] not in _VOWELS_EN
                      and stem[1] in _VOWELS_EN and stem[2] not in _VOWELS_EN):
                    stem += "e"
                w = stem
            break
    # step 1c: y -> i after consonant
    if w.endswith("y") and len(w) > 2 and w[-2] not in _VOWELS_EN:
        w = w[:-1] + "i"
    # step 2-4: derivational suffixes (one strip)
    for suf, rep in (("ization", "ize"), ("ational", "ate"),
                     ("fulness", "ful"), ("ousness", "ous"),
                     ("iveness", "ive"), ("tional", "tion"),
                     ("biliti", "ble"), ("lessli", "less"),
                     ("entli", "ent"), ("ation", "ate"), ("alism", "al"),
                     ("aliti", "al"), ("ousli", "ous"), ("iviti", "ive"),
                     ("fulli", "ful"), ("ness", ""), ("ment", ""),
                     ("ible", ""), ("able", ""), ("alli", "al"),
                     ("ical", "ic"), ("ful", ""), ("ism", ""), ("ist", ""),
                     ("iti", ""), ("ous", ""), ("ive", ""), ("ize", ""),
                     ("ant", ""), ("ent", "")):
        if w.endswith(suf) and len(w) - len(suf) + len(rep) >= 3:
            w = w[: len(w) - len(suf)] + rep
            break
    return w


_STEMMERS = {
    "en": _stem_en,
    "es": _suffix_stemmer([
        ("aciones", "ación"), ("amientos", ""), ("amiento", ""),
        ("imiento", ""), ("adoras", ""), ("adores", ""), ("aciones", ""),
        ("logías", "log"), ("logía", "log"), ("idades", "idad"),
        ("mente", ""), ("ación", ""), ("adora", ""), ("ancia", ""),
        ("encia", ""), ("istas", "ista"), ("ismos", "ismo"),
        ("ables", ""), ("ibles", ""), ("iendo", ""), ("ando", ""),
        ("aran", ""), ("aron", ""), ("ieron", ""), ("erán", ""),
        ("arán", ""), ("aba", ""), ("ían", ""), ("ía", ""),
        ("idad", ""), ("able", ""), ("ible", ""), ("ados", "ad"),
        ("idos", "id"), ("ado", "ad"), ("ido", "id"), ("oso", ""),
        ("osa", ""), ("ar", ""), ("er", ""), ("ir", ""),
        ("es", ""), ("os", "o"), ("as", "a"), ("s", "")]),
    "fr": _suffix_stemmer([
        ("issements", ""), ("issement", ""), ("issantes", ""),
        ("issante", ""), ("issants", ""), ("issant", ""),
        ("atrices", ""), ("atrice", ""), ("ations", ""), ("ation", ""),
        ("ateurs", ""), ("ateur", ""), ("ements", ""), ("ement", ""),
        ("euses", "eu"), ("ives", "if"), ("ment", ""), ("euse", "eu"),
        ("ités", "it"), ("ité", "it"), ("ance", ""), ("ence", ""),
        ("aux", "al"), ("eux", "eu"), ("ive", "if"), ("ant", ""),
        ("ait", ""), ("ais", ""), ("ent", ""), ("ons", ""), ("ez", ""),
        ("és", ""), ("ée", ""), ("er", ""), ("é", ""),
        ("es", ""), ("s", ""), ("e", "")]),
    "de": _suffix_stemmer([
        ("igkeiten", "ig"), ("igkeit", "ig"), ("ungen", "ung"),
        ("heiten", "heit"), ("keiten", "keit"), ("erinnen", "er"),
        ("erin", "er"), ("lich", ""), ("isch", ""), ("heit", ""),
        ("keit", ""), ("ung", ""), ("end", ""), ("ern", ""),
        ("em", ""), ("en", ""), ("er", ""), ("es", ""),
        ("e", ""), ("s", "")], min_stem=4),
    "it": _suffix_stemmer([
        ("azioni", ""), ("azione", ""), ("amento", ""), ("amenti", ""),
        ("imento", ""), ("imenti", ""), ("mente", ""), ("ità", ""),
        ("ivi", "iv"), ("ive", "iv"), ("endo", ""), ("ando", ""),
        ("ato", ""), ("ata", ""), ("ati", ""), ("ate", ""),
        ("uto", ""), ("ito", ""), ("are", ""), ("ere", ""), ("ire", ""),
        ("oso", ""), ("osa", ""), ("i", ""), ("e", ""), ("o", ""),
        ("a", "")]),
    "pt": _suffix_stemmer([
        ("amentos", ""), ("amento", ""), ("imento", ""), ("adoras", ""),
        ("adores", ""), ("ações", ""), ("mente", ""), ("adora", ""),
        ("ação", ""), ("idade", ""), ("ência", ""), ("ância", ""),
        ("ando", ""), ("endo", ""), ("indo", ""), ("ados", "ad"),
        ("idos", "id"), ("ado", "ad"), ("ido", "id"), ("oso", ""),
        ("osa", ""), ("ar", ""), ("er", ""), ("ir", ""),
        ("os", "o"), ("as", "a"), ("es", ""), ("s", "")]),
    "nl": _suffix_stemmer([
        ("heden", "heid"), ("ingen", "ing"), ("baar", ""), ("lijk", ""),
        ("ing", ""), ("end", ""), ("en", ""), ("je", ""),
        ("e", ""), ("s", "")], min_stem=4),
    "ru": _suffix_stemmer([
        ("иями", ""), ("ями", ""), ("ами", ""), ("ого", ""), ("его", ""),
        ("ому", ""), ("ему", ""), ("ыми", ""), ("ими", ""), ("ется", ""),
        ("ются", ""), ("ешь", ""), ("ете", ""), ("ают", ""), ("яют", ""),
        ("ала", ""), ("ила", ""), ("ыла", ""), ("ена", ""), ("ая", ""),
        ("яя", ""), ("ое", ""), ("ее", ""), ("ые", ""), ("ие", ""),
        ("ой", ""), ("ей", ""), ("ий", ""), ("ый", ""), ("ом", ""),
        ("ем", ""), ("ам", ""), ("ям", ""), ("ах", ""), ("ях", ""),
        ("ов", ""), ("ев", ""), ("ут", ""), ("ют", ""), ("ит", ""),
        ("ат", ""), ("ят", ""), ("ал", ""), ("ял", ""), ("ть", ""),
        ("а", ""), ("я", ""), ("о", ""), ("е", ""), ("ы", ""), ("и", ""),
        ("у", ""), ("ю", ""), ("ь", "")]),
    "sv": _suffix_stemmer([
        ("heterna", "het"), ("heten", "het"), ("heter", "het"),
        ("arna", ""), ("erna", ""), ("orna", ""), ("ande", ""),
        ("ende", ""), ("aste", ""), ("ade", ""), ("are", ""),
        ("ast", ""), ("en", ""), ("ar", ""), ("er", ""), ("or", ""),
        ("et", ""), ("a", ""), ("e", ""), ("t", ""), ("s", "")]),
    "fi": _suffix_stemmer([
        ("issa", ""), ("issä", ""), ("ista", ""), ("istä", ""),
        ("illa", ""), ("illä", ""), ("ilta", ""), ("iltä", ""),
        ("ille", ""), ("ssa", ""), ("ssä", ""), ("sta", ""), ("stä", ""),
        ("lla", ""), ("llä", ""), ("lta", ""), ("ltä", ""), ("lle", ""),
        ("ksi", ""), ("iin", ""), ("een", ""), ("ina", ""), ("inä", ""),
        ("ien", ""), ("jen", ""), ("en", ""), ("in", ""), ("t", ""),
        ("n", ""), ("a", ""), ("ä", "")]),
    # --- ten more of TransmogrifAI's Lucene
    # analyzer languages, same ordered longest-suffix-first design ---
    "da": _suffix_stemmer([
        ("hederne", "hed"), ("heden", "hed"), ("heder", "hed"),
        ("erne", ""), ("ene", ""), ("erede", ""), ("ende", ""),
        ("ede", ""), ("er", ""), ("en", ""), ("et", ""),
        ("e", ""), ("s", "")], min_stem=3),
    "no": _suffix_stemmer([
        ("hetene", "het"), ("heten", "het"), ("heter", "het"),
        ("ene", ""), ("ane", ""), ("ende", ""), ("ede", ""),
        ("ert", ""), ("este", ""), ("er", ""), ("en", ""), ("et", ""),
        ("a", ""), ("e", ""), ("s", "")], min_stem=3),
    "pl": _suffix_stemmer([
        ("ościami", "ość"), ("ościach", "ość"), ("ością", "ość"),
        ("ości", "ość"), ("owania", ""), ("owanie", ""), ("ego", ""),
        ("emu", ""), ("ach", ""), ("ami", ""), ("ych", ""), ("ymi", ""),
        ("iej", ""), ("ej", ""), ("ów", ""), ("om", ""), ("ie", ""),
        ("ia", ""), ("ą", ""), ("ę", ""), ("y", ""), ("i", ""),
        ("e", ""), ("a", ""), ("o", ""), ("u", "")], min_stem=3),
    "tr": _suffix_stemmer([
        ("larının", ""), ("lerinin", ""), ("larında", ""),
        ("lerinde", ""), ("lardan", ""), ("lerden", ""), ("ların", ""),
        ("lerin", ""), ("ları", ""), ("leri", ""), ("ında", ""),
        ("inde", ""), ("unda", ""), ("ünde", ""), ("ından", ""),
        ("inden", ""), ("lar", ""), ("ler", ""), ("dan", ""),
        ("den", ""), ("tan", ""), ("ten", ""), ("da", ""), ("de", ""),
        ("ta", ""), ("te", ""), ("ın", ""), ("in", ""), ("un", ""),
        ("ün", ""), ("ı", ""), ("i", ""), ("u", ""), ("ü", "")],
        min_stem=3),
    "id": _suffix_stemmer([
        ("kannya", ""), ("annya", ""), ("kan", ""), ("nya", ""),
        ("lah", ""), ("kah", ""), ("an", ""), ("i", "")], min_stem=4),
    "cs": _suffix_stemmer([
        ("ostech", "ost"), ("ostem", "ost"), ("ostmi", "ost"),
        ("osti", "ost"), ("ování", ""), ("ech", ""), ("ích", ""),
        ("ami", ""), ("emi", ""), ("ého", ""), ("ému", ""), ("ých", ""),
        ("ým", ""), ("ům", ""), ("ou", ""), ("ů", ""), ("é", ""),
        ("ý", ""), ("á", ""), ("í", ""), ("y", ""), ("i", ""),
        ("e", ""), ("a", ""), ("o", ""), ("u", "")], min_stem=3),
    "sk": _suffix_stemmer([
        ("ostiach", "ost"), ("ostiam", "ost"), ("osťami", "ost"),
        ("osti", "ost"), ("osť", "ost"), ("ovanie", ""), ("och", ""),
        ("iach", ""), ("ách", ""), ("ám", ""), ("ami", ""), ("ého", ""), ("ému", ""),
        ("ých", ""), ("ým", ""), ("ov", ""), ("ou", ""), ("é", ""),
        ("ý", ""), ("á", ""), ("í", ""), ("y", ""), ("i", ""),
        ("e", ""), ("a", ""), ("o", ""), ("u", "")], min_stem=3),
    "ro": _suffix_stemmer([
        ("urilor", ""), ("urile", ""), ("elor", ""), ("ilor", ""),
        ("ului", ""),
        ("ează", ""), ("ească", ""), ("ele", ""), ("ile", ""),
        ("are", ""), ("ere", ""), ("ire", ""), ("ii", ""), ("ul", ""),
        ("ă", ""), ("a", ""), ("e", ""), ("i", "")], min_stem=3),
    "hu": _suffix_stemmer([
        ("okból", ""), ("ekből", ""), ("okban", ""), ("ekben", ""),
        ("ában", ""), ("ében", ""), ("ságok", "ság"), ("ségek", "ség"),
        ("ból", ""), ("ből", ""), ("ban", ""), ("ben", ""),
        ("nak", ""), ("nek", ""), ("val", ""), ("vel", ""),
        ("ról", ""), ("ről", ""), ("hoz", ""), ("hez", ""),
        ("ság", ""), ("ség", ""), ("ok", ""), ("ek", ""), ("ak", ""),
        ("át", ""), ("et", ""), ("ot", ""), ("t", ""), ("k", "")],
        min_stem=3),
    "el": _suffix_stemmer([
        ("ότητας", ""), ("ότητα", ""), ("ματος", "μα"), ("ματα", "μα"),
        ("ικός", ""), ("ικής", ""), ("ική", ""), ("ικό", ""),
        ("ους", ""), ("ων", ""), ("ες", ""), ("ος", ""), ("ου", ""),
        ("ας", ""), ("ης", ""), ("α", ""), ("η", ""), ("ο", ""),
        ("ι", "")], min_stem=3),
    # --- ten more of TransmogrifAI's Lucene
    # analyzer inventory, incl. Arabic with its normalizer ---
    "uk": _suffix_stemmer([
        ("іями", ""), ("ями", ""), ("ами", ""), ("ого", ""), ("ього", ""),
        ("ому", ""), ("ьому", ""), ("ими", ""), ("іми", ""), ("ється", ""),
        ("ються", ""), ("еш", ""), ("ете", ""), ("ають", ""), ("яють", ""),
        ("ала", ""), ("ила", ""), ("ена", ""), ("ості", "іст"),
        ("остей", "іст"), ("а", ""), ("я", ""), ("о", ""), ("е", ""),
        ("и", ""), ("і", ""), ("у", ""), ("ю", ""), ("ь", ""),
        ("ий", ""), ("ій", ""), ("ої", ""), ("ів", ""), ("ах", ""),
        ("ях", ""), ("ом", ""), ("ем", ""), ("ам", ""), ("ям", ""),
        ("ти", "")]),
    "bg": _suffix_stemmer([
        ("остите", "ост"), ("остта", "ост"), ("овете", ""), ("ията", ""),
        ("ите", ""), ("ата", ""), ("ята", ""), ("ове", ""), ("ето", ""),
        ("та", ""), ("то", ""), ("те", ""), ("ът", ""),
        ("ят", ""), ("ия", ""), ("ваше", ""), ("еше", ""), ("аха", ""),
        ("а", ""), ("я", ""), ("о", ""), ("е", ""), ("и", ""),
        ("у", "")]),
    "ca": _suffix_stemmer([
        ("aments", ""), ("ament", ""), ("acions", ""), ("ació", ""),
        ("itats", ""), ("itat", ""), ("ments", ""), ("ment", ""),
        ("istes", "ista"), ("able", ""), ("ible", ""), ("ança", ""),
        ("ència", ""), ("ant", ""), ("ent", ""), ("ats", "at"),
        ("ada", ""), ("ades", ""), ("ar", ""), ("er", ""), ("ir", ""),
        ("es", ""), ("os", ""), ("s", ""), ("a", ""), ("e", "")]),
    "gl": _suffix_stemmer([
        ("amentos", ""), ("amento", ""), ("acións", ""), ("ación", ""),
        ("idades", "idade"), ("idade", ""), ("mente", ""), ("ando", ""),
        ("endo", ""), ("indo", ""), ("ados", "ad"), ("idos", "id"),
        ("ado", "ad"), ("ido", "id"), ("oso", ""), ("osa", ""),
        ("ar", ""), ("er", ""), ("ir", ""), ("os", "o"), ("as", "a"),
        ("es", ""), ("s", "")]),
    "lt": _suffix_stemmer([
        ("iausias", ""), ("iausia", ""), ("uose", ""), ("uosiuose", ""),
        ("iams", ""), ("omis", ""), ("amis", ""), ("ams", ""),
        ("ais", ""), ("oms", ""), ("ose", ""), ("ius", ""), ("iai", ""),
        ("iui", ""), ("imas", ""), ("imo", ""), ("ių", ""), ("as", ""),
        ("is", ""), ("ys", ""), ("us", ""), ("os", ""), ("ai", ""),
        ("ui", ""), ("ės", ""), ("ę", ""), ("ų", ""), ("ą", ""),
        ("į", ""), ("o", ""), ("a", ""), ("e", ""), ("i", ""),
        ("u", ""), ("ė", ""), ("y", "")]),
    "lv": _suffix_stemmer([
        ("šanas", ""), ("šanu", ""), ("šana", ""), ("ības", "ība"),
        ("ību", "ība"), ("iem", ""), ("ajiem", ""), ("ajām", ""),
        ("ām", ""), ("am", ""), ("as", ""), ("ai", ""), ("ie", ""),
        ("os", ""), ("us", ""), ("is", ""), ("es", ""), ("em", ""),
        ("im", ""), ("u", ""), ("a", ""), ("e", ""), ("i", ""),
        ("s", ""), ("š", "")]),
    "et": _suffix_stemmer([
        ("dele", ""), ("dest", ""), ("dega", ""), ("desse", ""),
        ("tele", ""), ("test", ""), ("tega", ""), ("sse", ""),
        ("st", ""), ("le", ""), ("lt", ""), ("ga", ""), ("ks", ""),
        ("ni", ""), ("na", ""), ("de", ""), ("te", ""), ("id", ""),
        ("s", ""), ("t", ""), ("d", ""), ("e", ""), ("a", ""),
        ("i", ""), ("u", "")], min_stem=3),
    "hi": _suffix_stemmer([
        ("ियों", ""), ("ाओं", ""), ("ाएं", ""), ("ुओं", ""), ("ुएं", ""),
        ("ों", ""), ("ें", ""), ("ीं", ""), ("ां", ""), ("ाँ", ""),
        ("े", ""), ("ी", ""), ("ि", ""), ("ा", ""), ("ु", ""),
        ("ू", ""), ("ो", "")], min_stem=2),
}


# ---------------------------------------------------------------------------
# Arabic-script normalization + stemming (Lucene ArabicNormalizer/
# ArabicStemmer light10 role; Persian variant normalizes to Farsi forms)
# ---------------------------------------------------------------------------

#: tashkeel (harakat) diacritics + tatweel stripped by normalization
_AR_DIACRITICS = set("ًٌٍَُِّْ"
                     "ـ")
_AR_PREFIXES = ("وال", "بال", "كال", "فال", "لل", "ال")
_AR_SUFFIXES = ("ها", "ان", "ات", "ون", "ين", "يه", "ية", "ه", "ة", "ي")


def _normalize_ar(w: str) -> str:
    """Arabic normalization: strip diacritics/tatweel, unify alef variants,
    alef-maqsura -> ya, teh-marbuta -> ha."""
    out = []
    for ch in w:
        if ch in _AR_DIACRITICS:
            continue
        if ch in "آأإ":   # آ أ إ -> ا
            ch = "ا"
        elif ch == "ى":             # ى -> ي
            ch = "ي"
        elif ch == "ة":             # ة -> ه
            ch = "ه"
        out.append(ch)
    return "".join(out)


def _stem_ar(w: str) -> str:
    w = _normalize_ar(w)
    for p in _AR_PREFIXES:
        if w.startswith(p) and len(w) - len(p) >= 2:
            w = w[len(p):]
            break
    for s in _AR_SUFFIXES:
        if w.endswith(s) and len(w) - len(s) >= 2:
            w = w[: -len(s)]
            break
    return w


def _normalize_fa(w: str) -> str:
    """Persian normalization: Arabic yeh/kaf -> Farsi forms, strip
    diacritics, drop the ZWNJ joiner (plural 'ها' attaches with it)."""
    out = []
    for ch in w:
        if ch in _AR_DIACRITICS or ch == "‌":   # ZWNJ
            continue
        if ch == "ي":               # ي -> ی
            ch = "ی"
        elif ch == "ك":             # ك -> ک
            ch = "ک"
        out.append(ch)
    return "".join(out)


_FA_SUFFIXES = ("هایی", "های", "ها", "ترین", "تر", "ات", "ان", "ام",
                "اش", "ی")


def _stem_fa(w: str) -> str:
    w = _normalize_fa(w)
    for s in _FA_SUFFIXES:
        if w.endswith(s) and len(w) - len(s) >= 2:
            w = w[: -len(s)]
            break
    return w


_STEMMERS["ar"] = _stem_ar
_STEMMERS["fa"] = _stem_fa

STEMMED_LANGUAGES: Tuple[str, ...] = tuple(sorted(_STEMMERS))


def stem(token: str, language: str) -> str:
    """Stem one token; identity for languages without a stemmer."""
    s = _STEMMERS.get(language)
    return s(token) if s else token


def stem_tokens(tokens: List[str], language: str) -> List[str]:
    s = _STEMMERS.get(language)
    return [s(t) for t in tokens] if s else list(tokens)


def analyzer_languages() -> Tuple[str, ...]:
    """Languages with a full analyzer (stemmer + stopwords) — the
    LuceneTextAnalyzer per-language analyzer inventory role."""
    return tuple(sorted(set(_STEMMERS) & set(STOPWORDS)))


def normalize_text(text: str) -> str:
    """NFC normalization (analyzers assume composed forms)."""
    return unicodedata.normalize("NFC", text)
